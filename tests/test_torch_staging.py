"""Staged steps (``sdr_channelizer_tpu_torch/_staging.py``), the port's
counterpart of ``jax.jit``: on the CPU a staged step is its eager form, so
the steps that the JAX package compiles (``step_fused``, the wideband
step, the tracker's dwell) are held here against the JAX package's jitted
ones on the same NumPy inputs; then the staging module's own rules (the
key, the clones, no cache on the CPU, no card and no fallback).  The CUDA
graphs themselves are held on the card by
``tests/test_torch_card_paths.py::test_staged_steps``.

Run alone: ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_staging.py
-q -p no:cacheprovider``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.capture import EventTracker as JTracker
from sdr_channelizer_tpu.config import PdwConfig as JPdwConfig
from sdr_channelizer_tpu.io import iqpacket
from sdr_channelizer_tpu.models.pipeline import (
    ChannelizerPipeline as JPipeline,
    WidebandPdwPipeline as JWideband,
)
from sdr_channelizer_tpu_torch import _staging
from sdr_channelizer_tpu_torch._staging import Staged, map_tensors
from sdr_channelizer_tpu_torch.capture import EventTracker
from sdr_channelizer_tpu_torch.config import PdwConfig
from sdr_channelizer_tpu_torch.dsp import pdw as tpdw
from sdr_channelizer_tpu_torch.models.pipeline import (
    ChannelizerPipeline,
    WidebandPdwPipeline,
)
from sdr_channelizer_tpu_torch.ops import cuda as kernels
from torch_port_fixtures import M, PDW_FIELDS, pulse_capture

torch.set_num_threads(1)

CFG = JPdwConfig.channelized(max_pulses=64, max_pulse_samples=256)
EXACT = ("toa_idx", "te_idx", "pw_sec", "saturated", "valid", "count")
WIDE_CFG = dict(max_pulses=16, max_pulse_samples=1024)
FS = 8e6


# ------------------------------------------------- port against the JAX package

@pytest.fixture(scope="module")
def fused():
    """The clipped capture's int16 planes through the JAX package's jitted
    ``step_fused`` (its cm2 kernels in interpret mode) and the port's
    staged one (the plain versions on the CPU)."""
    samples = pulse_capture(12)
    xr, xi = (np.ascontiguousarray(samples[:, k]) for k in (0, 1))
    jpipe = JPipeline.create(M, pdw_cfg=CFG)
    tpipe = ChannelizerPipeline.from_reference(
        np.asarray(jpipe.channelizer.taps_rev), dataclasses.asdict(CFG),
        device="cpu")
    ref = jpipe.step_fused(jnp.asarray(xr), jnp.asarray(xi), bit_width=12)
    got = tpipe.step_fused(xr, xi, bit_width=12)
    return ref, got, tpipe, (xr, xi)


@pytest.mark.parametrize("field", EXACT)
def test_step_fused_matches_jax_step_fused(fused, field):
    (_, _, ref), (_, _, got), _, _ = fused
    assert int(got.count.sum()) > 8
    np.testing.assert_array_equal(getattr(got, field).numpy(),
                                  np.asarray(getattr(ref, field)), field)


def test_step_fused_float_fields_match_jax(fused):
    """At ``test_torch_pipeline.py``'s tolerances for the cm2 step: the
    channelizer body sums in another order than the JAX kernel, so the
    medians move in the last places; 50 Hz at the decimated rate."""
    (_, _, ref), (_, _, got), _, _ = fused
    np.testing.assert_allclose(got.mag.numpy(), np.asarray(ref.mag),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(ref.snr_db),
                               rtol=0, atol=1e-3)
    f_got, f_ref = got.freq_offset_hz.numpy(), np.asarray(ref.freq_offset_hz)
    np.testing.assert_array_equal(np.isnan(f_got), np.isnan(f_ref))
    ok = ~np.isnan(f_ref)
    np.testing.assert_allclose(f_got[ok], f_ref[ok], rtol=0,
                               atol=50.0 / (FS / M))


def test_step_fused_floor_matches_jax_and_the_eager_form(fused):
    (nf_ref, _, _), (nf, _, batch), tpipe, (xr, xi) = fused
    np.testing.assert_allclose(nf.numpy(), np.asarray(nf_ref), rtol=1e-5,
                               atol=1e-5)
    nf_e, _, eager = tpipe.forward_fused(xr, xi, bit_width=12)
    assert torch.equal(nf, nf_e)
    for field in PDW_FIELDS:
        assert torch.equal(getattr(batch, field), getattr(eager, field))


def test_wideband_step_matches_jax_step():
    samples = pulse_capture(12, clip=False, seed=3)
    iq = iqpacket.to_complex(samples, 12)
    ref_nf, ref = JWideband(JPdwConfig.wideband(**WIDE_CFG)).step(
        jnp.asarray(iq))
    nf, got = WidebandPdwPipeline(PdwConfig.wideband(**WIDE_CFG),
                                  device="cpu").step(iq)
    np.testing.assert_allclose(nf.numpy(), np.asarray(ref_nf), rtol=2e-7)
    assert int(got.count) > 0
    for field in ("toa_idx", "te_idx", "pw_sec", "saturated", "valid",
                  "count"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)), field)
    np.testing.assert_allclose(got.mag.numpy(), np.asarray(ref.mag),
                               rtol=2e-7, atol=0)
    np.testing.assert_allclose(got.snr_db.numpy(), np.asarray(ref.snr_db),
                               rtol=0, atol=1e-5)


def _dwell():
    """A dwell of a 10 us pulsed tone at 1 Msps, made with NumPy from a
    seed: (float32 planes, the radio the trackers read the rate from)."""
    rng = np.random.default_rng(5)
    n = 80_000
    t = np.arange(n)
    iq = 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for s in range(500, n - 20, 5000):
        iq[s:s + 10] += 0.5 * np.exp(2j * np.pi * 0.1 * t[s:s + 10])
    iq[40_000:40_004] = 1.0                    # saturated samples
    planes = [np.ascontiguousarray(v, np.float32) for v in (iq.real, iq.imag)]
    return planes, types.SimpleNamespace(sample_rate_sps=1e6, gain_db=60.0)


def test_tracker_dwell_matches_jax_extract_planes():
    (xr, xi), radio = _dwell()
    ref = np.asarray(JTracker(radio=radio, dwell_sec=0.08)._extract_planes(
        jnp.asarray(xr), jnp.asarray(xi)))
    tracker = EventTracker(radio=radio, dwell_sec=0.08, device="cpu")
    eager = tracker.extract_planes(torch.from_numpy(xr), torch.from_numpy(xi))
    staged = tracker._device_dwell(xr, xi)
    assert torch.equal(staged, eager)
    got = eager.numpy()
    assert got.shape == ref.shape == (3, tracker.pdw_cfg.max_pulses)
    assert got[0, 0] == ref[0, 0] > 3 and got[0, 1] == ref[0, 1] == 1.0
    np.testing.assert_allclose(got[0, 2], ref[0, 2], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[0, 3:], ref[0, 3:])
    np.testing.assert_array_equal(got[1], ref[1])
    # test_torch_pdw_event.py's tolerance: the port's mean amplitude sums
    # the blocks' prefix in float64, the JAX package in float32
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=2e-4)


def test_tracker_stages_its_dwell_on_what_it_reads():
    _, radio = _dwell()
    tracker = EventTracker(radio=radio, dwell_sec=0.08, device="cpu")
    assert tracker._dwell_args() == dict(
        fs=1e6, saturation_level=tracker.saturation_level,
        snr_threshold_db=tracker.pdw_cfg.snr_threshold_db,
        max_pulses=tracker.pdw_cfg.max_pulses)
    assert tracker._staged_dwell.static_argnames == set(tracker._dwell_args())


def test_wideband_step_is_eager_from_the_blocked_length(monkeypatch):
    """Below ``_WIDEBAND_BLOCKED_FROM`` samples the step is the staged
    forward; from it on the step is not one graph (the blocked tail
    compacts on the host): on the CPU the eager forward, on the card the
    blocked tail with each block staged
    (``test_torch_streaming_staged.py``)."""
    pipe = WidebandPdwPipeline(PdwConfig.wideband(**WIDE_CFG), device="cpu")
    calls = []
    pipe._staged_forward = lambda x: calls.append(len(x)) or "staged"
    monkeypatch.setattr(tpdw, "_WIDEBAND_BLOCKED_FROM", 4096)
    x = np.zeros(4095, np.complex64)
    assert pipe.step(x) == "staged" and calls == [4095]
    nf, batch = pipe.step(np.zeros(4096, np.complex64))
    assert calls == [4095] and batch.toa_idx.shape == (16,)


def test_channelizer_steps_go_through_their_staged_forms(fused):
    _, _, tpipe, (xr, xi) = fused
    iq = (xr.astype(np.float32) + 1j * xi.astype(np.float32)) / 2048.0
    ref = tpipe.forward(iq)
    for a, b in zip(tpipe.step(iq)[:2], ref[:2]):
        assert torch.equal(a, b)
    planes = tpipe.step_planes(iq.real.astype(np.float32),
                               iq.imag.astype(np.float32))
    assert torch.equal(planes[3].toa_idx, ref[2].toa_idx)
    assert tpipe._staged_forward_packed.static_argnames == \
        {"bit_width", "route"}
    assert tpipe._staged_forward_fused.static_argnames == \
        {"bit_width", "route"}


# ---------------------------------------------------- the staging module's rules

def _add(x, y, *, scale=1.0, shift=0):
    return x * scale + y + shift


KEY_CASES = {
    "shape": (torch.zeros(5), torch.zeros(5)),
    "dtype": (torch.zeros(4, dtype=torch.float64), torch.zeros(4)),
    "contiguity": (torch.zeros(8)[::2], torch.zeros(4)),
    "static scale": None,
    "static shift": None,
}


@pytest.mark.parametrize("case", sorted(KEY_CASES))
def test_the_key_changes_with_each_part(case):
    staged = Staged(_add, "cpu", ("scale", "shift"))
    base = staged.key(torch.zeros(4), torch.zeros(4), scale=1.0, shift=0)
    assert staged.key(torch.ones(4), torch.ones(4), scale=1.0, shift=0) == base
    args = KEY_CASES[case] or (torch.zeros(4), torch.zeros(4))
    static = dict(scale=1.0, shift=0)
    if case.startswith("static"):
        name = case.split()[1]
        static[name] = 2.0 if name == "scale" else 1
    assert staged.key(*args, **static) != base


def test_the_key_of_a_host_array_is_that_of_its_tensor():
    staged = Staged(_add, "cpu")
    a = np.zeros((3, 4), np.float32)
    assert staged.key(a, a) == staged.key(torch.zeros(3, 4),
                                          torch.zeros(3, 4))
    assert staged.key(a.T, a) != staged.key(np.ascontiguousarray(a.T), a)


def test_the_key_holds_the_device_and_the_tf32_switch(monkeypatch):
    staged = Staged(_add, "cpu")
    key = staged.key(torch.zeros(2), torch.zeros(2))
    assert key[0] == "cpu"
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        not torch.backends.cuda.matmul.allow_tf32)
    assert staged.key(torch.zeros(2), torch.zeros(2)) != key


def test_arguments_are_arrays_or_named_statics():
    staged = Staged(_add, "cpu", ("scale",))
    with pytest.raises(TypeError, match="static"):
        staged(torch.zeros(2), 3.0)
    with pytest.raises(TypeError, match="shift"):
        staged(torch.zeros(2), torch.zeros(2), shift=1)


def test_on_the_cpu_the_function_runs_every_call_and_nothing_is_cached():
    calls = []

    def fn(x, *, k):
        calls.append(k)
        return x + k

    staged = Staged(fn, "cpu", ("k",))
    host = np.arange(4, dtype=np.float32)
    for _ in range(3):
        out = staged(host, k=2)
        assert isinstance(out, torch.Tensor)
        assert torch.equal(out, torch.arange(4.0) + 2)
    assert calls == [2, 2, 2]
    assert len(staged) == 0 and staged.hits == staged.misses == 0


def test_clones_share_no_storage_with_the_outputs():
    batch = tpdw.PdwBatch(**{f.name: torch.arange(3) + i for i, f in
                             enumerate(dataclasses.fields(tpdw.PdwBatch))})
    out = (torch.ones(2), batch, [torch.zeros(1)], {"k": torch.ones(1)}, 7)
    copy = map_tensors(torch.Tensor.clone, out)
    assert type(copy) is tuple and type(copy[1]) is tpdw.PdwBatch
    assert copy[4] == 7 and isinstance(copy[2], list)
    pairs = [(out[0], copy[0]), (out[2][0], copy[2][0]),
             (out[3]["k"], copy[3]["k"])]
    pairs += [(getattr(batch, f.name), getattr(copy[1], f.name))
              for f in dataclasses.fields(tpdw.PdwBatch)]
    for a, b in pairs:
        assert torch.equal(a, b)
        assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()


def test_asked_for_the_card_without_one_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("cuda", None):
        with pytest.raises(RuntimeError, match="no.*available|none is"):
            Staged(_add, device)
    with pytest.raises(RuntimeError):
        ChannelizerPipeline.create(M)


def test_a_bound_method_is_held_weakly():
    pipe = WidebandPdwPipeline(PdwConfig.wideband(**WIDE_CFG), device="cpu")
    staged = pipe._staged_forward
    assert staged._fn() == pipe.forward
    del pipe
    assert staged._fn() is None


def test_launch_counts_read_and_add_every_wrappers_counter():
    counts = kernels.launch_counts()
    names = {(mod.__name__.rsplit(".", 1)[1], attr) for mod, attr in counts}
    assert names == {
        ("channelizer_kernel", "launches"),
        ("channelizer_kernel", "launches_cm"),
        ("channelizer_kernel", "launches_flat"),
        ("channelizer_kernel", "launches_complex"),
        ("latch_kernel", "launches"), ("latch_kernel", "launches_tm"),
        ("nf_kernel", "launches"),
        ("pulse_stats_kernel", "launches"),
        ("pulse_stats_kernel", "launches_dense"),
        ("pulse_stats_kernel", "launches_batched"),
        ("pulse_stats_kernel", "launches_dense_batched"),
        ("pulse_stats_kernel", "launches_long_window"),
        ("transpose_kernel", "launches"),
        ("transpose_kernel", "launches_wideband")}
    delta = {k: i + 1 for i, k in enumerate(sorted(counts, key=str))}
    kernels.add_launch_counts(delta)
    try:
        assert kernels.launch_counts() == {k: counts[k] + delta[k]
                                           for k in counts}
    finally:
        kernels.add_launch_counts({k: -n for k, n in delta.items()})
    assert kernels.launch_counts() == counts


def test_keep_alive_holds_nothing_outside_a_capture():
    assert getattr(_staging._capturing, "held", None) is None
    _staging.keep_alive(torch.zeros(1))
    assert getattr(_staging._capturing, "held", None) is None


def test_a_failed_capture_names_its_cause_first():
    """A host sync inside a capture makes the capture's end fail too: the
    message leads with the sync's error, one line each."""
    try:
        try:
            raise RuntimeError("CUDA error: operation not permitted when "
                               "stream is capturing\nhint")
        except RuntimeError:
            raise RuntimeError("operation failed due to a previous error "
                               "during capture\nSearch")
    except RuntimeError as e:
        said = _staging._reasons(e)
    assert said == ("RuntimeError: CUDA error: operation not permitted when "
                    "stream is capturing -> RuntimeError: operation failed "
                    "due to a previous error during capture")
