"""The streamed slice as a whole: the port's ``dsp/streaming.py`` (plain
kernel versions on the CPU) against the JAX package's on the same ``.iq``
files, against the port's own single-shot extraction, and across a
checkpoint/resume, with checkpoints of either package."""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.config import PdwConfig as JPdwConfig
from sdr_channelizer_tpu.dsp.channelizer import Channelizer as JChannelizer
from sdr_channelizer_tpu.dsp.streaming import (
    CaptureSet as JCaptureSet,
    StreamingExtractor as JStreamingExtractor,
)
from sdr_channelizer_tpu.ops import medians as jmedians
from sdr_channelizer_tpu.signal.synth import PulseTrainSpec, pulse_train
from sdr_channelizer_tpu_torch.cli.main import main as cli_main
from sdr_channelizer_tpu_torch.config import PdwConfig
from sdr_channelizer_tpu_torch.dsp import channelizer as tchan
from sdr_channelizer_tpu_torch.dsp.streaming import (
    CaptureSet,
    StreamingExtractor,
)
from sdr_channelizer_tpu_torch.io import iqpacket
from sdr_channelizer_tpu_torch.models.pipeline import ChannelizerPipeline

torch.set_num_threads(1)

M = 8
FS = 8e6
T0 = 50.0
FC = 5e8
BLOCK, HALO = 512, 256
CFG_KW = dict(max_pulses=64, max_pulse_samples=256)
KEYS = ("toa", "freq", "pw", "mag", "snr", "sat", "channel")


def _capture(n_frames=1536, seed=5):
    """Two pulsed tones in noise: short pulses, and one train whose pulses
    straddle the block boundaries; a clipped stretch inside one pulse."""
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
    iq[3400:3440] = 1.0 + 1.0j   # full scale inside the first tone's pulse
    return iq


def _write(directory, iq, parts, bit_width=12, fs=FS, t0=T0):
    """The capture as ``parts`` contiguous dwell files (start times
    continuing), written with the port's ``write_iq``."""
    os.makedirs(directory, exist_ok=True)
    chunk = len(iq) // parts
    for k in range(parts):
        part = iq[k * chunk:] if k == parts - 1 else \
            iq[k * chunk:(k + 1) * chunk]
        hdr = iqpacket.IqHeader(
            frequency_hz=FC, bandwidth_hz=fs, sample_rate_sps=fs,
            rx_gain_db=0, num_samples=len(part), bit_width=bit_width,
            sample_start_time=t0 + k * chunk / fs)
        iqpacket.write_iq(os.path.join(directory, f"d{k}.iq"), hdr,
                          iqpacket.from_complex(part, bit_width))
    return str(directory)


def _extractor(**kw):
    kw = {"block_frames": BLOCK, "halo_frames": HALO, "device": "cpu", **kw}
    return StreamingExtractor(tchan.Channelizer.create(M),
                              PdwConfig.channelized(**CFG_KW), **kw)


def _jax_extractor(**kw):
    kw = {"block_frames": BLOCK, "halo_frames": HALO, **kw}
    return JStreamingExtractor(JChannelizer.create(M),
                               JPdwConfig.channelized(**CFG_KW), **kw)


def _assert_equal_dicts(got, ref):
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def _assert_key(key, got, ref, mag_exact=True):
    """The streamed path's bars: ``toa``, ``pw``, ``sat``, ``channel`` equal,
    ``freq`` at 50 Hz, ``snr`` at 1e-3 dB; ``mag`` equal within the port, and
    at the single-shot path's tolerance against the JAX kernels (the median
    goes through the plain products here, the interpreted kernel there)."""
    assert len(got[key]) == len(ref[key]) > 10
    if key == "freq":
        np.testing.assert_array_equal(np.isnan(got[key]), np.isnan(ref[key]))
        ok = ~np.isnan(ref[key])
        np.testing.assert_allclose(got[key][ok], ref[key][ok], rtol=0,
                                   atol=50.0)
    elif key == "snr":
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-3)
    elif key == "mag" and not mag_exact:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("dwells"), _capture(), parts=2)


@pytest.fixture(scope="module")
def segment(files):
    cs = CaptureSet.from_dir(files)
    assert len(cs.segments) == 1 and len(cs.segments[0].paths) == 2
    return cs.segments[0]


@pytest.fixture(scope="module")
def jax_fused(files, tmp_path_factory):
    """One interpret-mode run of the JAX package's fused streamed path
    (its kernel route switched on, as its own tests do), checkpointed."""
    ck = str(tmp_path_factory.mktemp("ck_jax"))
    seg = JCaptureSet.from_dir(files).segments[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmedians, "use_sort_free", lambda: True)
        out = _jax_extractor().extract_segment_fused(
            seg, fc=FC, checkpoint_dir=ck)
    return out, ck


@pytest.fixture(scope="module")
def port_fused(segment, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ck_port"))
    ext = _extractor()
    out = ext.extract_segment_fused(segment, fc=FC, checkpoint_dir=ck)
    return out, ck, ext.counters.snapshot()["counters"]


@pytest.fixture(scope="module")
def single_shot(segment):
    """The port's single-shot results on the concatenated payload: the
    packed main path and the FFT oracle route."""
    raw = segment.read_samples_raw(0, segment.num_samples)
    pipe = ChannelizerPipeline.create(
        M, pdw_cfg=PdwConfig.channelized(**CFG_KW), device="cpu")
    kw = dict(fs=FS, fc=FC, sample_start_time=T0)
    return (pipe.extract_fused(raw, bit_width=12, **kw),
            pipe.extract(iqpacket.to_complex(raw, 12), **kw))


# ----------------------------------------------------- the slice as a whole

@pytest.mark.parametrize("key", KEYS)
def test_fused_matches_jax_fused(jax_fused, port_fused, key):
    _assert_key(key, port_fused[0], jax_fused[0], mag_exact=False)


@pytest.mark.parametrize("key", KEYS)
def test_fused_equals_port_single_shot(port_fused, single_shot, key):
    _assert_key(key, port_fused[0], single_shot[0])


def test_fused_run_saw_what_it_should(port_fused):
    out, ck, counters = port_fused
    assert out["sat"].any() and not out["sat"].all()
    assert len(set(out["channel"])) >= 2
    assert sorted(os.listdir(ck)) == [
        "block_000000.npz", "block_000001.npz", "block_000002.npz",
        "noise_floor.npz"]
    assert counters["blocks_processed"] == 3
    assert counters["samples_ingested"] == 1536 * M
    assert counters["pulses_emitted"] == len(out["toa"])
    assert "blocks_resumed_from_checkpoint" not in counters


def test_fused_resume_is_bit_identical(segment, port_fused, tmp_path):
    out, ck, _ = port_fused
    mine = shutil.copytree(ck, tmp_path / "ck")
    os.remove(mine / "block_000002.npz")
    ext = _extractor()
    resumed = ext.extract_segment_fused(segment, fc=FC,
                                        checkpoint_dir=str(mine))
    assert ext.counters.get("blocks_resumed_from_checkpoint") == 2
    assert set(resumed) == set(out)
    _assert_equal_dicts(resumed, out)
    assert os.path.exists(mine / "block_000002.npz")


def test_checkpoints_hold_the_jax_packages_keys(jax_fused, port_fused):
    for name in ("block_000001.npz", "noise_floor.npz"):
        ref = np.load(os.path.join(jax_fused[1], name))
        got = np.load(os.path.join(port_fused[1], name))
        assert sorted(got.files) == sorted(ref.files)
        for key in ref.files:
            assert got[key].shape == ref[key].shape, (name, key)
            assert got[key].dtype == ref[key].dtype, (name, key)
    nf_ref = np.load(os.path.join(jax_fused[1], "noise_floor.npz"))["nf"]
    nf_got = np.load(os.path.join(port_fused[1], "noise_floor.npz"))["nf"]
    # medians of magnitudes near 4e-4, from sums of products near 1e-2
    np.testing.assert_allclose(nf_got, nf_ref, rtol=1e-4)


def test_resume_from_jax_written_checkpoints(segment, jax_fused, tmp_path):
    """The JAX package's noise floor and first two blocks, the port's
    third: the JAX run's result."""
    ref, ck = jax_fused
    mine = shutil.copytree(ck, tmp_path / "ck")
    os.remove(mine / "block_000002.npz")
    ext = _extractor()
    got = ext.extract_segment_fused(segment, fc=FC, checkpoint_dir=str(mine))
    assert ext.counters.get("blocks_resumed_from_checkpoint") == 2
    for key in KEYS:
        _assert_key(key, got, ref, mag_exact=False)
    # the resumed blocks are the JAX package's own bits
    in_first_two = ref["toa"] < T0 + 2 * BLOCK * M / FS
    assert in_first_two.sum() > 5
    for key in KEYS:
        np.testing.assert_array_equal(got[key][in_first_two],
                                      ref[key][in_first_two], err_msg=key)


def test_jax_package_resumes_from_port_written_checkpoints(
        files, port_fused, tmp_path, monkeypatch):
    """The reverse: every block from the port's files, none computed."""
    out, ck, _ = port_fused
    mine = shutil.copytree(ck, tmp_path / "ck")
    monkeypatch.setattr(jmedians, "use_sort_free", lambda: True)
    ext = _jax_extractor()
    got = ext.extract_segment_fused(JCaptureSet.from_dir(files).segments[0],
                                    fc=FC, checkpoint_dir=str(mine))
    assert ext.counters.get("blocks_resumed_from_checkpoint") == 3
    _assert_equal_dicts(got, out)


def test_fused_takes_a_given_noise_floor_and_rejects_other_modes(
        segment, port_fused):
    nf = np.load(os.path.join(port_fused[1], "noise_floor.npz"))["nf"]
    got = _extractor().extract_segment_fused(segment, fc=FC, noise_floor=nf)
    _assert_equal_dicts(got, port_fused[0])
    with pytest.raises(ValueError, match="unsupported noise_floor"):
        _extractor().extract_segment_fused(segment, noise_floor="first_block")
    wide = StreamingExtractor(None, PdwConfig.wideband(), device="cpu")
    with pytest.raises(ValueError, match="requires a channelizer"):
        wide.extract_segment_fused(segment)


def test_plain_switch_gives_the_same_result_on_the_cpu(segment, port_fused):
    got = _extractor(plain=True).extract_segment_fused(segment, fc=FC)
    _assert_equal_dicts(got, port_fused[0])


def test_block_too_long_for_float32_counts_is_rejected(segment):
    ext = _extractor(block_frames=(1 << 24) - 100)
    with pytest.raises(ValueError, match="2\\^24"):
        ext.extract_segment_fused(segment)


def test_ragged_blocks_and_int8_payload(tmp_path):
    """Blocks that do not divide the capture, a last block shorter than the
    halo, M = 12, and the int16-packed int8 payload."""
    m = 12
    iq = _capture(n_frames=1500)[: 1000 * m]
    seg = CaptureSet.from_dir(
        _write(tmp_path, iq * 0.5, parts=3, bit_width=8)).segments[0]
    raw = seg.read_samples_raw(0, seg.num_samples)
    assert raw.dtype == np.int8
    cfg = PdwConfig.channelized(**CFG_KW)
    pipe = ChannelizerPipeline.create(m, pdw_cfg=cfg, device="cpu")
    ref = pipe.extract_fused(raw, bit_width=8, fs=FS, fc=FC,
                             sample_start_time=T0)
    ext = StreamingExtractor(pipe.channelizer, cfg, block_frames=300,
                             halo_frames=256, device="cpu")
    got = ext.extract_segment_fused(seg, fc=FC)
    assert ext.counters.get("blocks_processed") == 4
    for key in KEYS:
        _assert_key(key, got, ref)


# ------------------------------------------------ the plain PyTorch routes

@pytest.fixture(scope="module")
def jax_oracle(files, tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ck_jax_oracle"))
    seg = JCaptureSet.from_dir(files).segments[0]
    return _jax_extractor().extract_segment(seg, fc=FC, checkpoint_dir=ck), ck


def _assert_oracle_close(got, ref):
    """Between the two packages' FFT routes: ``torch.fft`` and XLA's FFT
    differ in the last place."""
    assert len(got["toa"]) == len(ref["toa"]) > 10
    for key in ("toa", "pw", "sat", "channel"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_allclose(got["mag"], ref["mag"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["snr"], ref["snr"], rtol=0, atol=1e-3)
    ok = ~np.isnan(ref["freq"])
    np.testing.assert_allclose(got["freq"][ok], ref["freq"][ok], rtol=0,
                               atol=50.0)


def test_extract_segment_matches_jax_and_single_shot(
        segment, jax_oracle, single_shot, tmp_path):
    ck = tmp_path / "ck"
    ext = _extractor()
    got = ext.extract_segment(segment, fc=FC, checkpoint_dir=str(ck))
    _assert_oracle_close(got, jax_oracle[0])
    # block outputs concatenate bit for bit to the port's oracle route
    _assert_equal_dicts(got, single_shot[1])
    # resume: bit-identical, and only the dropped block is computed
    os.remove(ck / "block_000001.npz")
    resumed = ext.extract_segment(segment, fc=FC, checkpoint_dir=str(ck))
    _assert_equal_dicts(resumed, got)
    assert ext.counters.get("blocks_resumed_from_checkpoint") == 2
    for name in ("block_000001.npz", "noise_floor.npz"):
        ref = np.load(os.path.join(jax_oracle[1], name))
        mine = np.load(ck / name)
        assert sorted(mine.files) == sorted(ref.files)
        assert all(mine[k].shape == ref[k].shape
                   and mine[k].dtype == ref[k].dtype for k in ref.files)


@pytest.mark.parametrize("block_samples", [BLOCK * M, 5000])
def test_extract_matches_single_shot(segment, single_shot, block_samples):
    """Sample blocks that are no multiple of M take the frame carry."""
    ext = _extractor()
    got = ext.extract(lambda: segment.iter_samples(block_samples), fs=FS,
                      fc=FC, sample_start_time=T0)
    _assert_equal_dicts(got, single_shot[1])
    c = ext.counters
    assert c.get("samples_ingested") == 1536 * M
    assert c.get("blocks_processed") == -(-1536 * M // block_samples)
    assert c.get("pulses_emitted") == len(got["toa"])


def test_extract_matches_jax_extract(files, segment):
    jseg = JCaptureSet.from_dir(files).segments[0]
    kw = dict(fs=FS, fc=FC, sample_start_time=T0)
    ref = _jax_extractor().extract(lambda: jseg.iter_samples(5000), **kw)
    got = _extractor().extract(lambda: segment.iter_samples(5000), **kw)
    _assert_oracle_close(got, ref)


def test_extract_first_block_and_given_floor(segment, single_shot):
    kw = dict(fs=FS, fc=FC, sample_start_time=T0)
    blocks = lambda: segment.iter_samples(BLOCK * M)  # noqa: E731
    first = _extractor().extract(blocks, noise_floor="first_block", **kw)
    assert len(first["toa"]) > 10
    nf = _extractor().measure_noise_floor(blocks)
    given = _extractor().extract(blocks, noise_floor=nf, **kw)
    _assert_equal_dicts(given, single_shot[1])


def _wideband_files(directory):
    rng = np.random.default_rng(9)
    n = 2048 * M
    iq = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    tone = np.exp(2j * np.pi * 0.113 * np.arange(n)).astype(np.complex64)
    for s0 in range(400, n - 900, 2500):
        iq[s0:s0 + 800] = 0.9 * tone[s0:s0 + 800]
    return _write(directory, iq, parts=2, bit_width=16, t0=7.0)


def test_wideband_routes_match_jax(tmp_path):
    """``channelizer=None``: full rate, one channel, no kernel."""
    d = _wideband_files(tmp_path)
    cfg_kw = dict(max_pulses=64, max_pulse_samples=4096)
    jseg = JCaptureSet.from_dir(d).segments[0]
    ref = JStreamingExtractor(None, JPdwConfig.wideband(**cfg_kw),
                              block_frames=5000).extract_segment(jseg)
    seg = CaptureSet.from_dir(d).segments[0]
    ext = StreamingExtractor(None, PdwConfig.wideband(**cfg_kw),
                             block_frames=5000, device="cpu")
    got = ext.extract_segment(seg)
    assert len(got["toa"]) == len(ref["toa"]) > 4
    assert set(got) == set(ref)
    for key in ("toa", "pw", "sat"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    # torch.abs and XLA's abs of a complex number differ in the last place
    np.testing.assert_allclose(got["mag"], ref["mag"], rtol=2e-7, atol=0)
    np.testing.assert_allclose(got["snr"], ref["snr"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["freq"], ref["freq"], rtol=0, atol=50.0)
    it = ext.extract(lambda: seg.iter_samples(7168), fs=FS,
                     sample_start_time=7.0)
    _assert_equal_dicts(it, got)


# ------------------------------------------------------------ noise floors

@pytest.fixture(scope="module")
def magnitudes(segment):
    iq = segment.read_samples(0, segment.num_samples)
    return tchan.channelize(iq, tchan.Channelizer.create(M),
                            device="cpu").abs().numpy()


@pytest.mark.parametrize("n_frames", [1536, 1535], ids=["even", "odd"])
def test_measure_noise_floor_is_the_exact_median(segment, magnitudes,
                                                 n_frames):
    iq = segment.read_samples(0, n_frames * M)

    def blocks():
        for k in range(0, len(iq), 3001):
            yield iq[k:k + 3001]

    got = _extractor().measure_noise_floor(blocks)
    assert got.dtype == np.float32 and got.shape == (M,)
    np.testing.assert_array_equal(
        got, np.median(magnitudes[:n_frames], axis=0).astype(np.float32))


def _cm_blocks(y, size):
    """A factory of the channel-major (M, t) blocks of the (T, M) ``y``, in
    time order, ``size`` frames each (the last ragged)."""
    return lambda: (torch.from_numpy(np.ascontiguousarray(y[k:k + size].T))
                    for k in range(0, len(y), size))


@pytest.mark.parametrize("n_frames", [1536, 1535], ids=["even", "odd"])
def test_noise_floor_device_is_the_exact_median(magnitudes, n_frames):
    """Both routes over the capture's magnitudes as channel-major blocks:
    the kernel route's one select and the plain route's count descent."""
    y = magnitudes[:n_frames]
    ref = np.median(y, axis=0).astype(np.float32)
    plain = _extractor(plain=True)
    for ext in (_extractor(), plain):
        got = ext._noise_floor_device(_cm_blocks(y, 500), M, n_frames)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    assert plain.counters.get("nf_device_count_d2h_bytes") > 0


def test_noise_floor_device_with_ties_and_negative_zero():
    """Counts are integers: many equal values, and both zeros, pick the
    middle order statistics all the same, on either route."""
    rng = np.random.default_rng(3)
    y = np.round(np.abs(rng.standard_normal((401, 3))) * 4).astype(np.float32) / 4
    y[::7, 1] = -0.0
    for ext in (_extractor(), _extractor(plain=True)):
        got = ext._noise_floor_device(_cm_blocks(y, 100), 3, 401)
        np.testing.assert_array_equal(got, np.median(y, axis=0))


def _crafted_magnitudes(n):
    """(n, 7) float32 whose columns' middles are awkward: noise; ties (the
    middle inside a run of equal values); both zeros (even ``n``: -0 and +0
    are the two middles, odd: -0 alone is the middle); +inf above the
    middle; +inf over it; NaN above the middle; NaN over it.  Each column
    shuffled."""
    rng = np.random.default_rng(11)
    k = n // 2
    y = rng.random((n, 7), dtype=np.float32) + np.float32(0.5)
    y[:, 1] = np.round(y[:, 1] * 4) / 4
    zeros = [-0.0, 0.0] if n % 2 == 0 else [-0.0]
    below = k - 1 + n % 2
    y[:, 2] = np.concatenate([-y[:below, 2], zeros,
                              y[below + len(zeros):, 2]])
    y[: n // 3, 3] = np.inf
    y[: 3 * n // 5, 4] = np.inf
    y[: n // 3, 5] = np.nan
    y[: 3 * n // 5, 6] = np.nan
    for c in range(7):
        y[:, c] = rng.permutation(y[:, c])
    return y


def _nf_host(y):
    """The host-histogram form's floor of the (T, M) ``y``."""
    return _extractor()._noise_floor_from_mag_blocks(lambda: iter([y]))


@pytest.mark.parametrize("n_frames", [1000, 999], ids=["even", "odd"])
def test_kernel_floor_is_the_count_descent_bit_for_bit(n_frames):
    """The kernel route's one select over ragged channel-major blocks gives
    the sort median (NaNs sorting high) and the plain route's count descent
    bit for bit; ``np.median`` on the columns without NaN.

    One corner differs, where no integer recording goes: at an even total
    with a NaN above the lower middle, the descent's finish pass takes the
    least value above it with ``amin``, which propagates the NaN (as the
    JAX package's ``jnp.min`` does), while the select, the host-histogram
    form and the single-shot floor read the upper middle."""
    y = _crafted_magnitudes(n_frames)
    blocks = _cm_blocks(y, 384)
    got = _extractor()._noise_floor_device(blocks, 7, n_frames)
    descent = _extractor(plain=True)._noise_floor_device(blocks, 7, n_frames)
    s = np.sort(y, axis=0)
    ref = np.float32(0.5) * (s[(n_frames - 1) // 2] + s[n_frames // 2])
    assert got.dtype == np.float32 and got.shape == (7,)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    np.testing.assert_array_equal(
        got.view(np.uint32), _nf_host(y).view(np.uint32))
    same = np.arange(7) != (5 if n_frames % 2 == 0 else -1)
    np.testing.assert_array_equal(got[same].view(np.uint32),
                                  descent[same].view(np.uint32))
    assert n_frames % 2 == 1 or np.isnan(descent[5])
    np.testing.assert_array_equal(got[:5], np.median(y[:, :5], axis=0))
    assert np.signbit(got[2]) == (n_frames % 2 == 1) and got[2] == 0
    assert np.isinf(got[4]) and np.isfinite(got[5]) and np.isnan(got[6])


class _Made:
    """A block factory that counts the passes made over it."""

    def __init__(self, y, size):
        self.make, self.passes = _cm_blocks(y, size), 0

    def __call__(self):
        self.passes += 1
        return self.make()


def _spy_select(ext):
    """Record the (rows, t_len) of each call of ``ext``'s select."""
    ops, calls = ext._ops, []

    def select(mag_cm, t_len):
        calls.append((tuple(mag_cm.shape), t_len))
        return ops.noise_floor(mag_cm, t_len)

    ext._ops = dataclasses.replace(ops, noise_floor=select)
    return calls


@pytest.mark.parametrize("rows", [1, 3, 4])
def test_kernel_floor_goes_in_channel_groups_past_the_budget(rows):
    """Where the card holds fewer than all the channels' magnitudes and
    K2's candidates (five bytes a sample), the kernel route selects over
    groups of ``rows`` channels, one pass over the blocks and one select a
    group, and the floor is the same."""
    y = np.random.default_rng(7).random((300, M), dtype=np.float32)
    ext = _extractor()
    ext._nf_budget_bytes = lambda need: rows * 300 * 5 + 4
    calls = _spy_select(ext)
    made = _Made(y, 128)
    got = ext._noise_floor_device(made, M, 300)
    np.testing.assert_array_equal(got, np.median(y, axis=0))
    n_groups = -(-M // rows)
    assert made.passes == n_groups
    assert calls == [((min(rows, M - c0), 300), 300)
                     for c0 in range(0, M, rows)]


@pytest.mark.parametrize("plain", [False, True], ids=["kernel", "plain"])
def test_floor_streams_the_descent_where_no_channel_fits(plain):
    """Where not one channel's magnitudes fit the card, either route runs
    the count descent over blocks made anew for each of its nine passes,
    holding none; no select runs, and the floor is the exact median."""
    y = _crafted_magnitudes(999)[:, :5]
    ext = _extractor(plain=plain)
    ext._nf_budget_bytes = lambda need: 999 * 4
    calls = _spy_select(ext)
    made = _Made(y, 256)
    got = ext._noise_floor_device(made, 5, 999)
    np.testing.assert_array_equal(got, np.median(y, axis=0))
    assert made.passes == 9 and calls == []
    assert ext.counters.get("nf_device_count_d2h_bytes") > 0


def test_noise_floor_residency_cap_and_empty_streams():
    """Past the device's budget the floor is measured all the same, on
    either route; an empty stream has none."""
    y = np.random.default_rng(9).random((64, M), dtype=np.float32)
    for plain in (False, True):
        ext = _extractor(plain=plain)
        ext._nf_budget_bytes = lambda need: 64
        np.testing.assert_array_equal(
            ext._noise_floor_device(_cm_blocks(y, 16), M, 64),
            np.median(y, axis=0))
        with pytest.raises(ValueError, match="empty sample stream"):
            _extractor(plain=plain)._noise_floor_device(
                lambda: iter(()), M, 0)
    with pytest.raises(ValueError, match="empty sample stream"):
        _extractor().measure_noise_floor(lambda: iter(()))
    with pytest.raises(ValueError, match="12 frames, not 64"):
        _extractor()._noise_floor_device(_cm_blocks(y[:12], 8), M, 64)


def test_fused_noise_floor_equals_the_single_shot_floor(segment, port_fused):
    """The streamed floor over the blocks' magnitudes is the median of the
    single-shot magnitudes: the blocks hold the same bits."""
    raw = segment.read_samples_raw(0, segment.num_samples)
    pipe = ChannelizerPipeline.create(
        M, pdw_cfg=PdwConfig.channelized(**CFG_KW), device="cpu")
    xq = np.ascontiguousarray(raw).view(np.int32).ravel()
    nf, _, _ = pipe.forward_packed(xq, 12, route="cm2")
    got = np.load(os.path.join(port_fused[1], "noise_floor.npz"))["nf"]
    np.testing.assert_array_equal(got, nf.numpy())


# --------------------------------------------------- the extractor's set-up

def test_short_block_warning():
    with pytest.warns(UserWarning, match="shorter than the detection halo"):
        StreamingExtractor(tchan.Channelizer.create(M),
                           PdwConfig.channelized(max_pulses=32,
                                                 max_pulse_samples=1024),
                           block_frames=512, device="cpu")


def test_short_block_mid_stream_warns(segment):
    iq = segment.read_samples(0, segment.num_samples)

    def blocks():
        yield iq[:4096]
        yield iq[4096:4096 + 100 * M]   # shorter than the halo, not the last
        yield iq[4096 + 100 * M:]

    with pytest.warns(UserWarning, match="arrived mid-stream"):
        _extractor().extract(blocks, fs=FS, noise_floor="first_block")


def test_from_reference_carries_the_parameters_across(segment, port_fused):
    jext = _jax_extractor()
    ext = StreamingExtractor.from_reference(
        np.asarray(jext.channelizer.taps_rev),
        dataclasses.asdict(jext.pdw_cfg), block_frames=BLOCK,
        halo_frames=HALO, device="cpu")
    np.testing.assert_array_equal(ext.channelizer.taps_rev,
                                  np.asarray(jext.channelizer.taps_rev))
    assert dataclasses.asdict(ext.pdw_cfg) == dataclasses.asdict(jext.pdw_cfg)
    got = ext.extract_segment_fused(segment, fc=FC)
    _assert_equal_dicts(got, port_fused[0])
    wide = StreamingExtractor.from_reference(
        None, dataclasses.asdict(JPdwConfig.wideband()), device="cpu")
    assert wide.channelizer is None and wide.block_frames == 65536


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        StreamingExtractor(None, PdwConfig.wideband())


# ------------------------------------------------- stream_block, the files

def test_stream_block_folds_to_one_shot_and_matches_jax(segment):
    iq = segment.read_samples(0, segment.num_samples)
    chan = tchan.Channelizer.create(M)
    jchan = JChannelizer.create(M)
    whole = tchan.channelize(iq, chan, device="cpu")
    state = chan.init_state("cpu")
    jstate = jchan.init_state()
    assert state.frames.shape == tuple(jstate.frames.shape)
    cuts = [0, 3 * M, 700 * M, 701 * M, len(iq)]   # a block shorter than P
    parts = []
    for lo, hi in zip(cuts, cuts[1:]):
        y, state = chan.stream_block(iq[lo:hi], state)
        jy, jstate = jchan.stream_block(jnp.asarray(iq[lo:hi]), jstate)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(state.frames.numpy(),
                                      np.asarray(jstate.frames))
        parts.append(y)
    assert torch.equal(torch.cat(parts), whole)
    y_dft, _ = chan.stream_block(iq[: 64 * M], chan.init_state("cpu"),
                                 method="dft")
    np.testing.assert_allclose(y_dft.numpy(), whole[:64].numpy(), rtol=1e-4,
                               atol=1e-5)


def test_fir_branches_history_is_checked():
    taps = torch.ones((4, 2))
    with pytest.raises(ValueError, match="history"):
        tchan.fir_branches(torch.ones((8, 2)), taps, torch.ones((2, 2)))


@pytest.mark.parametrize("start,count", [(0, 12288), (6100, 250),
                                         (12000, 1000), (20000, 10)])
def test_segment_reads_match_jax(files, segment, start, count):
    jseg = JCaptureSet.from_dir(files).segments[0]
    assert segment.num_samples == jseg.num_samples == 1536 * M
    assert segment.start_time == jseg.start_time == T0
    np.testing.assert_array_equal(segment.read_samples(start, count),
                                  jseg.read_samples(start, count))
    raw = segment.read_samples_raw(start, count)
    ref = jseg.read_samples_raw(start, count)
    assert raw.dtype == ref.dtype == np.int16 and raw.shape == ref.shape
    np.testing.assert_array_equal(raw, ref)


def test_iter_samples_matches_jax(files, segment):
    jseg = JCaptureSet.from_dir(files).segments[0]
    got = list(segment.iter_samples(5000))
    ref = list(jseg.iter_samples(5000))
    assert [len(b) for b in got] == [len(b) for b in ref] == [5000, 5000, 2288]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_mixed_payload_types_in_a_segment_are_rejected(tmp_path):
    iq = _capture(n_frames=64)
    half = len(iq) // 2
    for k, bw in enumerate((12, 8)):
        hdr = iqpacket.IqHeader(
            frequency_hz=FC, bandwidth_hz=FS, sample_rate_sps=FS,
            rx_gain_db=0, num_samples=half, bit_width=bw,
            sample_start_time=T0 + k * half / FS)
        iqpacket.write_iq(tmp_path / f"d{k}.iq", hdr,
                          iqpacket.from_complex(iq[k * half:][:half], bw))
    seg = CaptureSet.from_dir(str(tmp_path)).segments[0]
    with pytest.raises(ValueError, match="mixed payload"):
        seg.read_samples_raw(0, seg.num_samples)


def _dwell(path, t0, n=1000, fs=56e6):
    hdr = iqpacket.IqHeader(
        frequency_hz=0, bandwidth_hz=fs, sample_rate_sps=fs, rx_gain_db=0,
        num_samples=n, bit_width=12, sample_start_time=t0)
    iqpacket.write_iq(path, hdr, np.zeros((n, 2), np.int16))
    return str(path)


def test_capture_set_contiguity_matches_jax(tmp_path):
    """Contiguous dwells at a UTC epoch stay one segment (one float64 ulp
    there is several samples), a real gap splits, another rate splits, and
    the files are ordered by start time, not by name."""
    fs, n, t0 = 56e6, 1000, 1723800000.0
    paths = [_dwell(tmp_path / f"z{3 - k}.iq", t0 + k * n / fs)
             for k in range(3)]
    paths.append(_dwell(tmp_path / "gap.iq", t0 + (3 * n + 500) / fs))
    paths.append(_dwell(tmp_path / "rate.iq", t0 + (4 * n + 500) / fs,
                        fs=28e6))
    got = CaptureSet.from_paths(paths[::-1])
    ref = JCaptureSet.from_paths(paths[::-1])
    shape = [[os.path.basename(p) for p in s.paths] for s in got.segments]
    assert shape == [["z3.iq", "z2.iq", "z1.iq"], ["gap.iq"], ["rate.iq"]]
    assert shape == [[os.path.basename(p) for p in s.paths]
                     for s in ref.segments]
    assert [s.num_samples for s in got.segments] == [3 * n, n, n]
    # a strict tolerance without the guard would have split the first run
    gaps = [abs(t0 + k * n / fs - (t0 + (k - 1) * n / fs + n / fs)) * fs
            for k in (1, 2)]
    assert all(g <= 4 * np.spacing(t0) * fs for g in gaps)
    assert len(CaptureSet.from_dir(str(tmp_path)).segments) == 3
    assert CaptureSet.from_dir(str(tmp_path), "none*.iq").segments == []


# ----------------------------------------------------------------- the CLI

def test_cli_stream_channelized_on_two_files(files, port_fused, tmp_path,
                                             capsys):
    out = tmp_path / "pdw.npz"
    ck = tmp_path / "ck"
    argv = ["pdw", os.path.join(files, "d1.iq"), os.path.join(files, "d0.iq"),
            "--stream", "--channelized", "--bands", str(M),
            "--block-frames", str(BLOCK), "--max-pulses", "64",
            "--max-pulse-samples", "256", "--device", "cpu",
            "--checkpoint-dir", str(ck), "--metrics", "--out", str(out)]
    assert cli_main(argv) == 0
    text = capsys.readouterr().out
    assert "segment 0 (2 files, 12288 samples)" in text
    assert '"blocks_processed": 3' in text and '"files_processed": 2' in text
    got = np.load(out)
    assert sorted(got.files) == sorted(KEYS)
    order = np.argsort(port_fused[0]["toa"], kind="stable")
    for key in KEYS:
        np.testing.assert_array_equal(got[key], port_fused[0][key][order],
                                      err_msg=key)
    assert sorted(os.listdir(ck / "seg000"))[0] == "block_000000.npz"
    # again: everything from the checkpoints
    assert cli_main(argv) == 0
    assert '"blocks_resumed_from_checkpoint": 3' in capsys.readouterr().out


def test_cli_stream_wideband_and_separate_segments(tmp_path, capsys):
    d = _wideband_files(tmp_path / "a")
    late = _write(tmp_path / "b", _capture(n_frames=256), parts=1,
                  bit_width=16, t0=90.0)
    out = tmp_path / "wide.npz"
    argv = ["pdw", os.path.join(d, "d0.iq"), os.path.join(d, "d1.iq"),
            os.path.join(late, "d0.iq"), "--stream", "--block-frames", "5000",
            "--max-pulses", "64", "--device", "cpu", "--out", str(out)]
    assert cli_main(argv) == 0
    text = capsys.readouterr().out
    assert "segment 0 (2 files" in text and "segment 1 (1 files" in text
    got = np.load(out)
    assert len(got["toa"]) > 4 and (np.diff(got["toa"]) >= 0).all()
    assert (got["toa"] > 90.0).any() and (got["toa"] < 8.0).any()
