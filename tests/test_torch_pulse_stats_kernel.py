"""The port's pulse statistics (kernel K4's plain version) against the JAX
package's Pallas kernel on the same streams and slot grids: equal bit for
bit on the live slots, without and with the saturation mask, as a slot grid
and as a flat slot list."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.ops.pallas.pulse_stats_kernel import (
    pulse_stats as jax_pulse_stats,
    pulse_stats_dense as jax_pulse_stats_dense,
)
from sdr_channelizer_tpu_torch.ops.cuda import pulse_stats_kernel

torch.set_num_threads(1)

M, T_ARR, T_LEN, P_SLOTS = 8, 1024, 1000, 16


def _inputs():
    rng = np.random.default_rng(21)
    mag = np.abs(rng.standard_normal((M, T_ARR))).astype(np.float32)
    mag = np.round(mag * 16) / 16          # ties inside the windows
    dph = rng.uniform(-180, 180, (M, T_ARR)).astype(np.float32)
    mag[:, T_LEN:] = 0.0
    dph[:, T_LEN - 1:] = 0.0
    toa = np.full((M, P_SLOTS), T_LEN, np.int32)   # dead unless set below
    te = np.full((M, P_SLOTS), T_LEN, np.int32)
    for c in range(M):
        slots = [
            (5 + c, 5 + c),             # one sample: empty phase range
            (20, 21),                   # tiny
            (40 + c, 40 + c + 37),      # short, odd and even lengths
            (100, 100 + 127),           # exactly 128 samples
            (300 - c, 300 - c + 200),   # longer than 128
            (520, 520 + 400),           # capped at either window
            (T_LEN - 9 - c, T_LEN - 1),  # ends on the last sample
            (T_LEN - 5, T_LEN),         # still open: cut at t_len
        ]
        for j, (a, b) in enumerate(slots):
            toa[c, 2 * j], te[c, 2 * j] = a, b
    return mag, dph, toa, te


@pytest.fixture(scope="module", params=[128, 256])
def both(request):
    window = request.param
    mag, dph, toa, te = _inputs()
    ref = jax_pulse_stats(jnp.asarray(mag), jnp.asarray(dph), None,
                          jnp.asarray(toa), jnp.asarray(te), window=window,
                          interpret=True, t_len=T_LEN)
    got = pulse_stats_kernel.pulse_stats(
        torch.from_numpy(mag), torch.from_numpy(dph), torch.from_numpy(toa),
        torch.from_numpy(te), window, T_LEN)
    return (window, [np.asarray(r) for r in ref[:2]],
            [g.numpy() for g in got], toa, te, mag, dph)


@pytest.mark.parametrize("stream", [0, 1], ids=["mag", "dph"])
def test_live_slots_match_jax_kernel(both, stream):
    window, ref, got, toa, te, _, _ = both
    live = toa < T_LEN
    assert live.sum() == 8 * M
    np.testing.assert_array_equal(got[stream][live], ref[stream][live])


def test_against_numpy_median(both):
    window, _, got, toa, te, mag, dph = both
    for c in range(M):
        for p in range(P_SLOTS):
            a, b = int(toa[c, p]), int(te[c, p])
            if a >= T_LEN:
                assert got[0][c, p] == 0 and got[1][c, p] == 0  # dead slot
                continue
            plen = min(b - a + 1, window)
            mwin = mag[c, a:min(a + plen, T_LEN)]
            dwin = dph[c, a:min(a + plen - 1, T_LEN)]
            assert got[0][c, p] == np.float32(np.median(mwin))
            if dwin.size:
                assert got[1][c, p] == np.float32(np.median(dwin))
            else:
                assert np.isnan(got[1][c, p])


def test_wide_window_needs_no_other_route():
    """A window wider than the JAX kernel's bound, still exact."""
    rng = np.random.default_rng(2)
    mag = np.abs(rng.standard_normal((2, 9000))).astype(np.float32)
    dph = rng.standard_normal((2, 9000)).astype(np.float32)
    toa = np.array([[10, 9000], [4000, 50]], np.int32)
    te = np.array([[8000, 9000], [8999, 60]], np.int32)
    got = pulse_stats_kernel.pulse_stats(
        torch.from_numpy(mag), torch.from_numpy(dph), torch.from_numpy(toa),
        torch.from_numpy(te), 4096)
    assert got[0][0, 0] == np.float32(np.median(mag[0, 10:10 + 4096]))
    assert got[1][1, 0] == np.float32(np.median(dph[1, 4000:4000 + 4095]))
    assert got[0][1, 1] == np.float32(np.median(mag[1, 50:61]))
    assert got[0][0, 1] == 0


def test_bad_arguments():
    mag = torch.zeros((2, 64))
    idx = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        pulse_stats_kernel.pulse_stats(mag, mag, idx.long(), idx, 16)
    with pytest.raises(ValueError):
        pulse_stats_kernel.pulse_stats(mag, mag[:, :32], idx, idx, 16)
    with pytest.raises(ValueError):
        pulse_stats_kernel.pulse_stats(mag, mag, idx, idx, 0)


# ------------------------------------- the saturation mask, the flat list

def _sat_mask(toa, te):
    """A 0/1 mask with a few saturated samples, and for every channel one
    right on a leading edge, one right on a trailing edge (neither counts)
    and one strictly inside a pulse (counts)."""
    rng = np.random.default_rng(5)
    sat = (rng.random((M, T_ARR)) < 0.01).astype(np.float32)
    sat[:, T_LEN:] = 0.0
    for c in range(M):
        a, b = int(toa[c, 4]), int(te[c, 4])     # the 38-sample pulse
        sat[c, a - 2:b + 3] = 0.0
        sat[c, a] = sat[c, b] = 1.0              # on the edges only
        a, b = int(toa[c, 6]), int(te[c, 6])     # the 128-sample pulse
        sat[c, a:b + 1] = 0.0
        sat[c, a + 1 + c] = 1.0                  # strictly inside
        sat[c, 20:22] = 1.0                      # the tiny pulse: no interior
    return sat


@pytest.fixture(scope="module")
def with_sat():
    """Grid and flat-list results of both packages at window 256."""
    window = 256
    mag, dph, toa, te = _inputs()
    sat = _sat_mask(toa, te)
    rng = np.random.default_rng(6)
    perm = rng.permutation(M * P_SLOTS)
    chan = (perm // P_SLOTS).astype(np.int32)
    toa_f, te_f = toa.reshape(-1)[perm], te.reshape(-1)[perm]
    chan[toa_f >= T_LEN] = 0   # the JAX package's compaction leaves 0 there
    ref = jax_pulse_stats(jnp.asarray(mag), jnp.asarray(dph), jnp.asarray(sat),
                          jnp.asarray(toa), jnp.asarray(te), window=window,
                          interpret=True, t_len=T_LEN)
    ref_d = jax_pulse_stats_dense(
        jnp.asarray(mag), jnp.asarray(dph), jnp.asarray(sat),
        jnp.asarray(toa_f), jnp.asarray(te_f), jnp.asarray(chan),
        window=window, interpret=True, t_len=T_LEN)
    tm, td, ts = (torch.from_numpy(x) for x in (mag, dph, sat))
    got = pulse_stats_kernel.pulse_stats(
        tm, td, torch.from_numpy(toa), torch.from_numpy(te), window, T_LEN, ts)
    got_d = pulse_stats_kernel.pulse_stats_dense(
        tm, td, ts, torch.from_numpy(toa_f), torch.from_numpy(te_f),
        torch.from_numpy(chan), window, T_LEN)
    return {"grid": ([np.asarray(r) for r in ref], [g.numpy() for g in got],
                     toa < T_LEN),
            "dense": ([np.asarray(r) for r in ref_d],
                      [g.numpy() for g in got_d], toa_f < T_LEN),
            "perm": perm, "toa": toa, "te": te, "sat": sat}


@pytest.mark.parametrize("form", ["grid", "dense"])
@pytest.mark.parametrize("out", [0, 1, 2], ids=["mag", "dph", "saturated"])
def test_sat_and_dense_match_jax_kernel(with_sat, form, out):
    ref, got, live = with_sat[form]
    assert len(got) == 3 and got[out].shape == live.shape
    np.testing.assert_array_equal(got[out][live], ref[out][live])
    assert not got[out][~live].any()   # dead slots: 0 in every output


def test_flag_counts_strictly_inside_only(with_sat):
    flag = with_sat["grid"][1][2]
    toa, te, sat = with_sat["toa"], with_sat["te"], with_sat["sat"]
    assert not flag[:, 4].any()      # saturated on both edges, not inside
    assert flag[:, 6].all()          # one saturated sample inside
    assert not flag[:, 2].any()      # two samples: no interior
    for c in range(M):
        for p in range(P_SLOTS):
            a, b = int(toa[c, p]), int(te[c, p])
            if a >= T_LEN:
                continue
            plen = min(b - a + 1, 256)
            inside = sat[c, a + 1:min(a + plen - 1, T_LEN)]
            assert flag[c, p] == float(inside.any()), (c, p)


def test_dense_is_the_grid_in_another_order(with_sat):
    grid, dense, perm = with_sat["grid"][1], with_sat["dense"][1], with_sat["perm"]
    for g, d in zip(grid, dense):
        np.testing.assert_array_equal(d, g.reshape(-1)[perm])


def test_dense_without_mask_returns_two_outputs():
    mag, dph, toa, te = _inputs()
    chan = np.repeat(np.arange(M, dtype=np.int32), P_SLOTS)
    got = pulse_stats_kernel.pulse_stats_dense(
        torch.from_numpy(mag), torch.from_numpy(dph), None,
        torch.from_numpy(toa.reshape(-1)), torch.from_numpy(te.reshape(-1)),
        torch.from_numpy(chan), 128, T_LEN)
    grid = pulse_stats_kernel.pulse_stats(
        torch.from_numpy(mag), torch.from_numpy(dph), torch.from_numpy(toa),
        torch.from_numpy(te), 128, T_LEN)
    assert len(got) == 2
    for g, d in zip(grid, got):
        np.testing.assert_array_equal(d.numpy(), g.numpy().reshape(-1))


def test_bad_arguments_dense():
    mag = torch.zeros((2, 64))
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        pulse_stats_kernel.pulse_stats_dense(mag, mag, None, idx, idx,
                                             idx.long(), 16)
    with pytest.raises(ValueError):
        pulse_stats_kernel.pulse_stats_dense(mag, mag, None, idx, idx,
                                             idx[:3], 16)
    with pytest.raises(ValueError):
        pulse_stats_kernel.pulse_stats(mag, mag, idx.reshape(2, 2),
                                       idx.reshape(2, 2), 16,
                                       sat_cm=mag[:, :32])
