"""Kernel B10's plain versions and its choice against the JAX package: the
port's ``pulse_stats`` / ``pulse_stats_dense`` with ``batch_tiles=8``
against the JAX ``pulse_stats(..., batch_tiles=8)`` in interpret mode (the
batched Pallas kernel), bit for bit on the live slots; the list of live
tiles the batched kernel walks; and K4's plain versions at window 65,536,
past what a block's shared memory holds, against the JAX package's
sort-based ``masked_median``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.ops.medians import masked_median as jax_masked_median
from sdr_channelizer_tpu.ops.pallas.pulse_stats_kernel import (
    pulse_stats as jax_pulse_stats,
)
from sdr_channelizer_tpu_torch.ops.cuda import pulse_stats_kernel as psk

torch.set_num_threads(1)

# Two tiles of 128 slots: the smallest slot list on which the JAX package
# runs its batched kernel (an interpret-mode call costs about 50 s here).
M, T_LEN, P_SLOTS, WINDOW, N_PULSES = 2, 1024, 128, 128, 40


def _inputs():
    """As ``tests/test_pulse_stats_kernel.py``'s batched case, cut to two
    tiles: random pulses, some longer than the window, and a sparse
    saturation mask."""
    rng = np.random.default_rng(5)
    mag = np.abs(rng.standard_normal((M, T_LEN))).astype(np.float32)
    dph = rng.standard_normal((M, T_LEN)).astype(np.float32)
    sat = (rng.random((M, T_LEN)) < 0.01).astype(np.float32)
    toa = np.full((M, P_SLOTS), T_LEN, np.int32)
    te = np.full((M, P_SLOTS), T_LEN, np.int32)
    for c in range(M):
        starts = np.sort(rng.choice(T_LEN - 300, N_PULSES, replace=False))
        lens = rng.integers(1, 200, N_PULSES)
        toa[c, :N_PULSES] = starts
        te[c, :N_PULSES] = np.minimum(starts + lens, T_LEN - 1)
    return mag, dph, sat, toa, te


@pytest.fixture(scope="module")
def batched():
    mag, dph, sat, toa, te = _inputs()
    ref = jax_pulse_stats(jnp.asarray(mag), jnp.asarray(dph), jnp.asarray(sat),
                          jnp.asarray(toa), jnp.asarray(te), window=WINDOW,
                          interpret=True, batch_tiles=8)
    tm, td, ts = (torch.from_numpy(x) for x in (mag, dph, sat))
    grid = psk.pulse_stats(tm, td, torch.from_numpy(toa), torch.from_numpy(te),
                           WINDOW, sat_cm=ts, batch_tiles=8)
    perm = np.random.default_rng(6).permutation(M * P_SLOTS)
    chan = (perm // P_SLOTS).astype(np.int32)
    dense = psk.pulse_stats_dense(
        tm, td, ts, torch.from_numpy(toa.reshape(-1)[perm]),
        torch.from_numpy(te.reshape(-1)[perm]), torch.from_numpy(chan),
        WINDOW, batch_tiles=8)
    return {"ref": [np.asarray(r) for r in ref], "live": toa < T_LEN,
            "grid": [g.numpy() for g in grid],
            "dense": [d.numpy()[np.argsort(perm)].reshape(M, P_SLOTS)
                      for d in dense]}


def test_the_jax_package_batches_these_slots():
    """The port picks the batched kernel where the JAX package does: two
    tiles a batch here."""
    assert psk.batched_tiles(8, WINDOW, M * P_SLOTS) == 2


@pytest.mark.parametrize("form", ["grid", "dense"])
@pytest.mark.parametrize("out", [0, 1, 2], ids=["mag", "dph", "saturated"])
def test_batched_matches_jax_batched_kernel(batched, form, out):
    ref, got, live = batched["ref"], batched[form], batched["live"]
    assert live.sum() == M * N_PULSES
    np.testing.assert_array_equal(got[out][live], ref[out][live])
    assert not got[out][~live].any()   # dead slots: 0 in every output


def test_batch_tiles_changes_no_value(batched):
    mag, dph, sat, toa, te = (torch.from_numpy(x) for x in _inputs())
    for bt in (0, 1, 3):
        for a, b in zip(psk.pulse_stats(mag, dph, toa, te, WINDOW, sat_cm=sat,
                                        batch_tiles=bt), batched["grid"]):
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("window, n_slots, nt", [
    (128, 64 * 512, 8), (1024, 64 * 512, 5), (4096, 64 * 512, 1),
    (65536, 512, 1), (128, 100, 1), (128, 300, 3), (256, 64 * 512, 8),
])
def test_batched_tiles_follows_the_jax_choice(window, n_slots, nt):
    """``min(batch_tiles, 48 // rows, tiles)`` with rows = ceil(window/128)
    + 1: the main path's short tier (128) batches 8 tiles, its long tier
    (1024) 5, wider windows none."""
    assert psk.batched_tiles(8, window, n_slots) == nt
    assert psk.batched_tiles(0, window, n_slots) == 1
    assert psk.batched_tiles(1, window, n_slots) == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("nt", [2, 3, 8])
def test_live_tile_list_covers_exactly_the_live_tiles(seed, nt):
    """Walk the batched kernel's grid in Python over the list built on the
    device: every block below the live count visits its live tiles, in
    order, and together they are exactly the tiles with a live slot."""
    rng = np.random.default_rng(seed)
    n_slots = 128 * 11 + 37
    t_len = 1000
    toa = np.full(n_slots, t_len, np.int32)
    toa[5] = -3          # a negative index is dead too
    live_tiles = rng.random(12) < 0.4
    for t in np.flatnonzero(live_tiles):
        k = rng.integers(0, min(128, n_slots - 128 * t))
        toa[128 * t + k] = rng.integers(0, t_len)
    tile_ids, n_live, n_batches = psk._live_tiles(torch.from_numpy(toa),
                                                  t_len, nt)
    assert n_batches == -(-12 // nt) and tile_ids.numel() == n_batches * nt + 1
    ids = tile_ids.numpy()
    visited = [int(ids[b * nt + j]) for b in range(n_batches)
               if b * nt < int(n_live) for j in range(nt) if ids[b * nt + j] >= 0]
    assert visited == list(np.flatnonzero(live_tiles))
    assert int(n_live) == int(live_tiles.sum())


# ------------------------------------------------- K4 at window 65,536

LONG_T, LONG_W = 150_000, 65_536


def _long_inputs():
    rng = np.random.default_rng(9)
    mag = np.abs(rng.standard_normal((1, LONG_T))).astype(np.float32)
    mag = np.round(mag * 64) / 64          # ties inside the windows
    dph = rng.uniform(-180, 180, (1, LONG_T)).astype(np.float32)
    sat = (rng.random((1, LONG_T)) < 1e-4).astype(np.float32)
    slots = [(100, 100 + 559),            # a predict pulse: 560 samples
             (1000, 1000 + 59_999),       # about 60,000
             (70_000, 70_000 + 69_999),   # about 70,000: capped at the window
             (2, 2), (5, 6),              # one and two samples
             (LONG_T - 40_000, LONG_T + 9)]  # cut at t_len
    toa = np.array([[a for a, _ in slots] + [LONG_T]], np.int32)
    te = np.array([[b for _, b in slots] + [LONG_T]], np.int32)
    return mag, dph, sat, toa, te


def test_plain_stats_at_window_65536_match_jax_masked_median():
    mag, dph, sat, toa, te = _long_inputs()
    got = psk.pulse_stats(*(torch.from_numpy(x) for x in (mag, dph, toa, te)),
                          LONG_W, sat_cm=torch.from_numpy(sat))
    got_d = psk.pulse_stats_dense(
        *(torch.from_numpy(x) for x in (mag, dph, sat)),
        torch.from_numpy(toa[0]), torch.from_numpy(te[0]),
        torch.zeros(toa.shape[1], dtype=torch.int32), LONG_W)
    pos = np.arange(LONG_W)
    n_live = toa.shape[1] - 1
    wins = {k: np.zeros((n_live, LONG_W), np.float32) for k in ("m", "d", "s")}
    plens = []
    for s in range(n_live):
        i0, i1 = int(toa[0, s]), int(te[0, s])
        plen = min(i1 - i0 + 1, LONG_W)
        plens.append(plen)
        for k, x, fill in (("m", mag, np.inf), ("d", dph, 0.0), ("s", sat, 0)):
            w = x[0, i0:i0 + LONG_W]
            wins[k][s] = np.pad(w, (0, LONG_W - len(w)), constant_values=fill)
    plens = np.array(plens)[:, None]
    cut = np.minimum(plens, LONG_T - toa[0, :n_live, None])   # cut at t_len
    ref_m = np.asarray(jax_masked_median(jnp.asarray(wins["m"]),
                                         jnp.asarray(pos < cut), method="sort"))
    d_mask = pos < np.minimum(plens - 1, LONG_T - toa[0, :n_live, None])
    ref_d = np.asarray(jax_masked_median(jnp.asarray(wins["d"]),
                                         jnp.asarray(d_mask), method="sort"))
    ref_s = ((wins["s"] > 0.5) & d_mask & (pos >= 1)).any(-1)
    for out in (got, got_d):
        out = [o.numpy().reshape(-1) for o in out]
        np.testing.assert_array_equal(out[0][:n_live], ref_m)
        np.testing.assert_array_equal(out[1][:n_live], ref_d)
        np.testing.assert_array_equal(out[2][:n_live] > 0.5, ref_s)
        assert out[0][-1] == out[1][-1] == out[2][-1] == 0   # the dead slot
    assert ref_s[1] or ref_s[2]        # the mask is exercised
    assert np.isnan(ref_d[3])          # one sample: no phase step
