"""The streamed path's staged steps (``dsp/streaming.py``'s block steps,
``WidebandPdwPipeline.step``'s blocked tail) and its floor: the JAX
package's ``jax.jit`` sites on that path.  On the CPU a staged step is its
eager form, so these tests hold what does not need a graph:

* the plain route's count passes with the shift as a tensor against the
  JAX package's jitted ones, level by level; the kernel route's floor as
  one select over the blocks, no staged step;
* the latch entry chained on the device: without a checkpoint no block's
  transfer comes to the host, with one the ``.npz`` files are the eager
  run's and the JAX package resumes from them;
* every streamed entry point, and the wideband step from the blocked
  length, going through its ``Staged`` function, with the JAX package's
  PDWs;
* the keys a 16-block segment makes per staged function, within
  ``_staging.MAX_GRAPHS``.

The graphs themselves are held on the card by
``tests/test_torch_card_streaming.py`` and
``tests/test_torch_card_wideband.py``.

Run alone: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_streaming_staged.py -q -p no:cacheprovider``.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.config import PdwConfig as JPdwConfig
from sdr_channelizer_tpu.dsp import pdw as jpdw
from sdr_channelizer_tpu.dsp import streaming as jstreaming
from sdr_channelizer_tpu.dsp.channelizer import Channelizer as JChannelizer
from sdr_channelizer_tpu.ops import medians as jmedians
from sdr_channelizer_tpu.signal.synth import PulseTrainSpec, pulse_train
from sdr_channelizer_tpu_torch._staging import MAX_GRAPHS, Staged
from sdr_channelizer_tpu_torch.config import PdwConfig
from sdr_channelizer_tpu_torch.dsp import channelizer as tchan
from sdr_channelizer_tpu_torch.dsp import pdw as tpdw
from sdr_channelizer_tpu_torch.dsp import streaming as tstreaming
from sdr_channelizer_tpu_torch.io import iqpacket
from sdr_channelizer_tpu_torch.models.pipeline import WidebandPdwPipeline
from torch_port_fixtures import PDW_FIELDS

torch.set_num_threads(1)

M = 8
FS = 8e6
T0 = 50.0
FC = 5e8
BLOCK, HALO = 512, 256
CFG_KW = dict(max_pulses=64, max_pulse_samples=256)
KEYS = ("toa", "freq", "pw", "mag", "snr", "sat", "channel")
STEPS = ("fused_block", "floor_block", "detect_block")


def _capture(n_frames, seed=5):
    """Two pulsed tones in noise, one train's pulses straddling block
    boundaries, and a clipped stretch inside one pulse."""
    n = n_frames * M
    dur = n / FS
    specs = [
        PulseTrainSpec(sample_rate_sps=FS, duration_sec=dur,
                       frequency_hz=1.02e6, pulse_width_sec=120e-6,
                       pri_sec=410e-6, start_index=37),
        PulseTrainSpec(sample_rate_sps=FS, duration_sec=dur,
                       frequency_hz=-2.97e6, pulse_width_sec=150e-6,
                       pri_sec=503e-6, start_index=3900),
    ]
    rng = np.random.default_rng(seed)
    iq = sum(pulse_train(s) for s in specs)
    iq = (iq + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    iq[3400:3440] = 1.0 + 1.0j
    return iq


def _write(directory, iq, parts, bit_width=12):
    """The capture as ``parts`` contiguous dwell files."""
    os.makedirs(directory, exist_ok=True)
    chunk = len(iq) // parts
    for k in range(parts):
        part = iq[k * chunk:] if k == parts - 1 else \
            iq[k * chunk:(k + 1) * chunk]
        hdr = iqpacket.IqHeader(
            frequency_hz=FC, bandwidth_hz=FS, sample_rate_sps=FS,
            rx_gain_db=0, num_samples=len(part), bit_width=bit_width,
            sample_start_time=T0 + k * chunk / FS)
        iqpacket.write_iq(os.path.join(directory, f"d{k}.iq"), hdr,
                          iqpacket.from_complex(part, bit_width))
    return str(directory)


def _extractor(chan=True, cfg=None, **kw):
    kw = {"block_frames": BLOCK, "halo_frames": HALO, "device": "cpu", **kw}
    cfg = cfg or (PdwConfig.channelized(**CFG_KW) if chan
                  else PdwConfig.wideband(**CFG_KW))
    return tstreaming.StreamingExtractor(
        tchan.Channelizer.create(M) if chan else None, cfg, **kw)


def _jax_extractor(chan=True, **kw):
    kw = {"block_frames": BLOCK, "halo_frames": HALO, **kw}
    cfg = (JPdwConfig.channelized(**CFG_KW) if chan
           else JPdwConfig.wideband(**CFG_KW))
    return jstreaming.StreamingExtractor(
        JChannelizer.create(M) if chan else None, cfg, **kw)


class Spy:
    """Stands in for a ``Staged`` attribute: records each call's graph key,
    then calls the staged function."""

    def __init__(self, staged: Staged):
        self.staged = staged
        self.keys = []

    @property
    def fn(self):
        return self.staged.fn

    def __len__(self):      # as falsy as the staged function it stands for
        return len(self.staged)

    def __call__(self, *args, **static):
        self.keys.append(self.staged.key(*args, **static))
        return self.staged(*args, **static)


def _spy(ext) -> dict:
    spies = {}
    for name in STEPS:
        spies[name] = Spy(getattr(ext, f"_staged_{name}"))
        setattr(ext, f"_staged_{name}", spies[name])
    return spies


def _assert_key(key, got, ref, mag_rtol=0.0):
    """``toa``, ``pw``, ``sat``, ``channel`` equal, ``freq`` at 50 Hz,
    ``snr`` at 1e-3 dB, ``mag`` within ``mag_rtol``."""
    assert len(got[key]) == len(ref[key]) > 5
    if key == "freq":
        np.testing.assert_array_equal(np.isnan(got[key]), np.isnan(ref[key]))
        ok = ~np.isnan(ref[key])
        np.testing.assert_allclose(got[key][ok], ref[key][ok], rtol=0,
                                   atol=50.0)
    elif key == "snr":
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-3)
    elif key == "mag" and mag_rtol:
        np.testing.assert_allclose(got[key], ref[key], rtol=mag_rtol,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def _assert_same(got, ref):
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


# ------------------------------------------------------ the count passes

def _count_blocks():
    """Three (T, M) magnitude blocks with ties, +0 and -0, the largest
    float32 and +inf: the keys that a count or a finish can split."""
    rng = np.random.default_rng(11)
    ties = np.float32([0.0, 1e-3, 0.25, 0.5, 7.0, 3.4028235e38])
    blocks = []
    for t in (97, 97, 40):
        x = np.where(rng.random((t, 5)) < 0.5, rng.choice(ties, (t, 5)),
                     rng.random((t, 5), np.float32)).astype(np.float32)
        x[::7, 1] = -0.0
        x[3::11, 2] = 0.0
        x[5, 3] = np.inf
        blocks.append(x)
    return blocks


@pytest.fixture(scope="module")
def count_levels():
    """The radix descent of the streamed floor over ``_count_blocks``,
    level by level: each level's prefix, the JAX package's jitted counts
    and the port's (the shift a 0-d tensor), then the finish pass's."""
    blocks = _count_blocks()
    m = blocks[0].shape[1]
    n_total = sum(b.shape[0] for b in blocks)
    k_lo = (n_total - 1) // 2
    prefix = np.zeros(m, np.uint32)
    levels = []
    for level in range(8):
        shift = 28 - 4 * level
        ref = sum(np.asarray(jstreaming._nf_count_le(
            jnp.asarray(b), jnp.asarray(prefix.view(np.int32)), shift),
            np.float64) for b in blocks)
        got = sum(tstreaming._nf_count_le(
            torch.from_numpy(b), torch.from_numpy(prefix.astype(np.int64)),
            torch.tensor(shift, dtype=torch.int64)) for b in blocks)
        levels.append((ref, got.numpy()))
        nib = np.sum(ref <= k_lo, axis=1).astype(np.uint32)
        prefix |= nib << np.uint32(shift)
    ref_fin = [jstreaming._nf_finish(jnp.asarray(b),
                                     jnp.asarray(prefix.view(np.int32)))
               for b in blocks]
    got_fin = [tstreaming._nf_finish(torch.from_numpy(b),
                                     torch.from_numpy(prefix.astype(np.int64)))
               for b in blocks]
    return levels, ref_fin, got_fin, blocks


@pytest.mark.parametrize("level", range(8))
def test_count_pass_with_a_tensor_shift_matches_jax(count_levels, level):
    ref, got = count_levels[0][level]
    assert got.dtype == np.int64 and got.shape == ref.shape == (5, 15)
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    # the level splits the keys: not every count is 0 or all of them
    assert 0 < got.max() and got.min() < sum(
        b.shape[0] for b in count_levels[3])


def test_finish_pass_matches_jax(count_levels):
    _, ref_fin, got_fin, _ = count_levels
    for (rc, rm), (gc, gm) in zip(ref_fin, got_fin):
        np.testing.assert_array_equal(gc.numpy(), np.asarray(rc, np.int64))
        np.testing.assert_array_equal(gm.numpy().view(np.uint32),
                                      np.asarray(rm).view(np.uint32))


@pytest.mark.parametrize("ragged", [False, True], ids=["even", "ragged"])
def test_device_floor_is_one_select_over_the_blocks(ragged):
    """``_noise_floor_device`` over 16 channel-major blocks on the kernel
    route: one call of the select over all of them, no staged step, the
    exact median; the plain route's descent gives the same floor."""
    rng = np.random.default_rng(3)
    shapes = [64] * 15 + [20 if ragged else 64]
    mags = [torch.from_numpy(rng.random((5, t), np.float32)) for t in shapes]
    ext = _extractor()
    spies = _spy(ext)
    ops = ext._ops
    calls = []

    def select(mag_cm, t_len):
        calls.append((tuple(mag_cm.shape), t_len))
        return ops.noise_floor(mag_cm, t_len)

    ext._ops = dataclasses.replace(ops, noise_floor=select)
    n_total = sum(shapes)
    nf = ext._noise_floor_device(lambda: iter(mags), 5, n_total)
    ref = np.median(torch.cat(mags, dim=1).numpy(), axis=1)
    np.testing.assert_array_equal(nf, ref.astype(np.float32))
    assert calls == [((5, n_total), n_total)]
    assert all(not s.keys for s in spies.values())
    plain = _extractor(plain=True)._noise_floor_device(
        lambda: iter(mags), 5, n_total)
    np.testing.assert_array_equal(nf, plain)


# ------------------------------------------- the streamed run against JAX

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("dwells"), _capture(1536), parts=2)


@pytest.fixture(scope="module")
def segment(files):
    return tstreaming.CaptureSet.from_dir(files).segments[0]


@pytest.fixture(scope="module")
def jax_runs(files, tmp_path_factory):
    """The JAX package's streamed oracle runs on the files, once each:
    ``extract_segment`` (checkpointed) and ``extract``.  Its fused path is
    held against the port's eager one by ``test_torch_streaming.py``; an
    interpret-mode run of it here would cost two minutes for the same
    comparison, so the staged fused run is held against the oracle, at
    the tolerances that part the DFT's products from the FFT."""
    seg = jstreaming.CaptureSet.from_dir(files).segments[0]
    ck = str(tmp_path_factory.mktemp("ck_jax"))
    ext = _jax_extractor()
    oracle = ext.extract_segment(seg, fc=FC, checkpoint_dir=ck)
    nf = np.load(os.path.join(ck, "noise_floor.npz"))["nf"]
    stream = _jax_extractor().extract(
        lambda: seg.iter_samples(BLOCK * M), fs=FS, fc=FC,
        sample_start_time=T0, noise_floor=nf)
    return {"ck": ck, "segment": oracle, "extract": stream, "nf": nf}


@pytest.fixture(scope="module")
def port_fused(segment, tmp_path_factory):
    """The port's fused run through its staged steps, checkpointed, and the
    same run eagerly, checkpointed apart."""
    ck = str(tmp_path_factory.mktemp("ck_port"))
    ext = _extractor()
    spies = _spy(ext)
    out = ext.extract_segment_fused(segment, fc=FC, checkpoint_dir=ck)
    eager = _extractor()
    eager._eager = True
    eager_spies = _spy(eager)
    ck_eager = str(tmp_path_factory.mktemp("ck_eager"))
    ref = eager.extract_segment_fused(segment, fc=FC, checkpoint_dir=ck_eager)
    assert not any(s.keys for s in eager_spies.values())
    return out, ck, spies, ref, ck_eager


@pytest.mark.parametrize("key", KEYS)
def test_fused_goes_through_its_staged_steps_and_matches_jax(
        port_fused, jax_runs, key):
    out, _, spies, ref, _ = port_fused
    # the floor pass reads every block twice on the CPU (host histograms)
    assert len(spies["fused_block"].keys) == 3
    assert len(spies["floor_block"].keys) == 2 * 3
    _assert_key(key, out, jax_runs["segment"], mag_rtol=1e-5)
    np.testing.assert_array_equal(out[key], ref[key])


def test_fused_checkpoints_are_the_eager_runs_with_the_jax_keys(
        port_fused, jax_runs):
    _, ck, _, _, ck_eager = port_fused
    names = sorted(os.listdir(ck))
    assert names == sorted(os.listdir(ck_eager)) == sorted(
        os.listdir(jax_runs["ck"]))
    for name in names:
        got, ref = np.load(os.path.join(ck, name)), \
            np.load(os.path.join(ck_eager, name))
        jref = np.load(os.path.join(jax_runs["ck"], name))
        assert sorted(got.files) == sorted(ref.files) == sorted(jref.files)
        for key in got.files:
            assert got[key].dtype == jref[key].dtype, (name, key)
            assert got[key].shape == jref[key].shape, (name, key)
            assert got[key].tobytes() == ref[key].tobytes(), (name, key)


def test_jax_package_resumes_from_the_staged_runs_checkpoints(
        files, port_fused, tmp_path, monkeypatch):
    out, ck, _, _, _ = port_fused
    mine = shutil.copytree(ck, tmp_path / "ck")
    monkeypatch.setattr(jmedians, "use_sort_free", lambda: True)
    ext = _jax_extractor()
    got = ext.extract_segment_fused(
        jstreaming.CaptureSet.from_dir(files).segments[0], fc=FC,
        checkpoint_dir=str(mine))
    assert ext.counters.get("blocks_resumed_from_checkpoint") == 3
    _assert_same(got, out)


def test_resume_uploads_the_stored_transfer(segment, port_fused, tmp_path):
    out, ck, _, _, _ = port_fused
    mine = shutil.copytree(ck, tmp_path / "ck")
    os.remove(mine / "block_000002.npz")
    ext = _extractor()
    spies = _spy(ext)
    got = ext.extract_segment_fused(segment, fc=FC, checkpoint_dir=str(mine))
    assert ext.counters.get("blocks_resumed_from_checkpoint") == 2
    assert len(spies["fused_block"].keys) == 1
    _assert_same(got, out)


class Watched(torch.Tensor):
    """A tensor that counts the calls that bring it to the host."""

    fetches = 0

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("cpu", "numpy", "tolist",
                                             "item", "__array__"):
            cls.fetches += 1
        return super().__torch_function__(func, types, args, kwargs or {})


def _watched_transfers(ext):
    """Stand in for the fused block step: the real step, its ``a`` and
    ``b`` (and the entry chained from them) watched."""
    real = ext._staged_fused_block

    def step(hist, xq, nf, entry, **static):
        batch, a, b = real(hist, xq, nf, entry.as_subclass(torch.Tensor),
                           **static)
        return batch, a.as_subclass(Watched), b.as_subclass(Watched)

    ext._staged_fused_block = step


def test_without_a_checkpoint_no_transfer_comes_to_the_host(segment,
                                                           port_fused):
    ext = _extractor()
    _watched_transfers(ext)
    Watched.fetches = 0
    got = ext.extract_segment_fused(segment, fc=FC)
    assert Watched.fetches == 0
    _assert_same(got, port_fused[0])


def test_a_checkpoint_brings_each_transfer_to_the_host(segment, tmp_path):
    """The stand-in's counting works: with a checkpoint every block's
    ``a`` and ``b`` are fetched."""
    ext = _extractor()
    _watched_transfers(ext)
    Watched.fetches = 0
    ext.extract_segment_fused(segment, fc=FC,
                              checkpoint_dir=str(tmp_path / "ck"))
    assert Watched.fetches >= 2 * 3


@pytest.mark.parametrize("key", KEYS)
def test_extract_segment_goes_through_its_staged_step_and_matches_jax(
        segment, jax_runs, key):
    ext = _extractor()
    spies = _spy(ext)
    got = ext.extract_segment(segment, fc=FC)
    assert len(spies["detect_block"].keys) == 3
    _assert_key(key, got, jax_runs["segment"], mag_rtol=1e-5)


@pytest.mark.parametrize("key", KEYS)
def test_extract_goes_through_its_staged_step_and_matches_jax(
        segment, jax_runs, key):
    ext = _extractor()
    spies = _spy(ext)
    got = ext.extract(lambda: segment.iter_samples(BLOCK * M), fs=FS, fc=FC,
                      sample_start_time=T0, noise_floor=jax_runs["nf"])
    assert len(spies["detect_block"].keys) == 3
    _assert_key(key, got, jax_runs["extract"], mag_rtol=1e-5)


def test_wideband_extract_segment_goes_through_its_staged_step(tmp_path):
    """Wideband streaming (``pdw --stream`` without ``--channelized``):
    the oracle block step staged, the JAX package's PDWs."""
    rng = np.random.default_rng(9)
    n = 3 * BLOCK + 100
    iq = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    for s in range(40, n - 60, 170):
        iq[s:s + 50] += 0.5 * np.exp(2j * np.pi * 0.07 * np.arange(50))
    d = _write(tmp_path / "w", iq, parts=1)
    ext = _extractor(chan=False)
    spies = _spy(ext)
    got = ext.extract_segment(tstreaming.CaptureSet.from_dir(d).segments[0])
    ref = _jax_extractor(chan=False).extract_segment(
        jstreaming.CaptureSet.from_dir(d).segments[0])
    assert len(spies["detect_block"].keys) == 4
    for key in ("toa", "pw", "sat", "channel"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert len(got["toa"]) > 5
    # torch.abs and XLA's abs of a complex number differ in the last place
    np.testing.assert_allclose(got["mag"], ref["mag"], rtol=2e-7, atol=0)
    np.testing.assert_allclose(got["snr"], ref["snr"], rtol=0, atol=1e-5)


# ----------------------------------------- the blocked wideband step

def test_wideband_step_stages_each_block_from_the_blocked_length(
        monkeypatch):
    """``WidebandPdwPipeline.step`` from the blocked length, with the card's
    routing (the kernel tail, here its plain versions): every block through
    the staged block step, two keys (the blocks with a halo, the last with
    its +inf pad); the PDWs the eager blocked run's bit for bit, and the
    JAX package's single-shot oracle's."""
    blk = 4096
    monkeypatch.setattr(tpdw, "_WIDEBAND_BLOCKED_FROM", blk)
    monkeypatch.setattr(tpdw, "_WIDEBAND_BLOCK_LEN", blk)
    monkeypatch.setattr(tpdw, "_kernel_tail",
                        lambda stats, where: stats != "xla")
    cfg_kw = dict(max_pulses=16, max_pulse_samples=512)
    rng = np.random.default_rng(4)
    n = 3 * blk
    iq = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    tone = 0.5 * np.exp(2j * np.pi * 0.05 * np.arange(400))
    for s in (300, blk - 150, 6000, 2 * blk + 900):
        iq[s:s + 400] += tone
    iq[n - 200:] += tone[:200]                  # open at the end
    pipe = WidebandPdwPipeline(PdwConfig.wideband(**cfg_kw), device="cpu")
    calls = []
    pipe._staged_forward = lambda x: calls.append(x) or None
    spy = Spy(pipe._staged_block)
    pipe._staged_block = spy
    nf, got = pipe.step(iq)
    assert not calls and len(spy.keys) == 3 and len(set(spy.keys)) == 2

    x = torch.from_numpy(iq)
    mag, ph, sat = tpdw._prep_streams(x, pipe.pdw_cfg.saturation_level)
    eager = tpdw._extract_wideband_blocked(mag, ph, sat, pipe.pdw_cfg, nf)
    for field in PDW_FIELDS:
        assert torch.equal(getattr(got, field), getattr(eager, field)), field

    xj = jnp.asarray(iq)
    nf_j = jmedians.median(jnp.abs(xj))
    ref = jpdw.extract_pdws(xj, JPdwConfig.wideband(**cfg_kw),
                            noise_floor=nf_j, stats="xla")
    np.testing.assert_allclose(float(nf), float(nf_j), rtol=2e-7)
    assert int(got.count) == int(ref.count) == 4
    for field in ("toa_idx", "te_idx", "pw_sec", "saturated", "valid",
                  "count"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)), field)
    np.testing.assert_allclose(got.mag.numpy(), np.asarray(ref.mag),
                               rtol=2e-7, atol=0)
    for field in ("snr_db", "freq_offset_hz"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=3e-7, atol=2e-5, err_msg=field)


def test_wideband_step_below_the_blocked_length_is_one_graph():
    pipe = WidebandPdwPipeline(PdwConfig.wideband(max_pulses=4,
                                                  max_pulse_samples=64),
                               device="cpu")
    spy = Spy(pipe._staged_forward)
    pipe._staged_forward = spy
    pipe._staged_block = None     # never reached below the blocked length
    pipe.step(np.zeros(4096, np.complex64))
    assert len(spy.keys) == 1


# ------------------------------------------------ keys of a long segment

LONG_BLOCK, LONG_HALO = 64, 32


def _long_segment(tmp_path, n_frames):
    """A 16-block segment of 64-frame blocks, pulses of 20 frames."""
    rng = np.random.default_rng(21)
    n = n_frames * M
    iq = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    t = np.arange(20 * M)
    for s in range(50 * M, n - 30 * M, 90 * M):
        iq[s:s + 20 * M] += 0.5 * np.exp(2j * np.pi * 0.19 * t)
    d = _write(tmp_path, iq, parts=2)
    return tstreaming.CaptureSet.from_dir(d).segments[0]


@pytest.mark.parametrize("ragged", [False, True], ids=["even", "ragged"])
def test_a_16_block_segment_keeps_its_keys_within_the_cap(tmp_path, ragged):
    """Even: the first block (no history), the middle blocks and the last
    (no halo) are three fused keys, the floor pass two (with and without a
    history), the oracle step two (with a halo, with the +inf pad).  A last
    block shorter than the halo adds the block before it (a short halo)
    and itself: four, three and three."""
    n_frames = 15 * LONG_BLOCK + (20 if ragged else LONG_BLOCK)
    seg = _long_segment(tmp_path, n_frames)
    cfg = PdwConfig.channelized(max_pulses=8, max_pulse_samples=LONG_HALO)
    kw = dict(cfg=cfg, block_frames=LONG_BLOCK, halo_frames=LONG_HALO)
    ext = _extractor(**kw)
    spies = _spy(ext)
    fused = ext.extract_segment_fused(seg)
    oracle = ext.extract_segment(seg)
    streamed = ext.extract(lambda: seg.iter_samples(LONG_BLOCK * M), fs=FS)
    assert len(fused["toa"]) > 5 and len(oracle["toa"]) > 5
    assert len(streamed["toa"]) == len(oracle["toa"])
    keys = {name: len(set(s.keys)) for name, s in spies.items()}
    calls = {name: len(s.keys) for name, s in spies.items()}
    assert calls["fused_block"] == 16 and calls["floor_block"] == 2 * 16
    assert calls["detect_block"] == 2 * 16
    assert keys == {"fused_block": 4 if ragged else 3,
                    "floor_block": 3 if ragged else 2,
                    "detect_block": 3 if ragged else 2}
    assert max(keys.values()) <= MAX_GRAPHS


def test_a_none_argument_is_part_of_the_key():
    def fn(h, x):
        return x if h is None else x + h

    staged = Staged(fn, "cpu")
    x = torch.ones(3)
    assert staged.key(None, x) != staged.key(x, x)
    assert staged.key(None, x) == staged.key(None, x + 1)
    assert torch.equal(staged(None, x), x)
    assert torch.equal(staged(x, x), 2 * x)
