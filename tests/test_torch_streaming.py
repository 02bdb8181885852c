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


@pytest.mark.parametrize("n_frames", [1536, 1535], ids=["even", "odd"])
def test_noise_floor_device_is_the_exact_median(magnitudes, n_frames):
    y = magnitudes[:n_frames]
    ext = _extractor()
    got = ext._noise_floor_device(
        lambda: (torch.from_numpy(y[k:k + 500]) for k in range(0, len(y), 500)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.median(y, axis=0).astype(np.float32))
    assert ext.counters.get("nf_device_count_d2h_bytes") > 0


def test_noise_floor_device_with_ties_and_negative_zero():
    """Counts are integers: many equal values, and both zeros, pick the
    middle order statistics all the same."""
    rng = np.random.default_rng(3)
    y = np.round(np.abs(rng.standard_normal((401, 3))) * 4).astype(np.float32) / 4
    y[::7, 1] = -0.0
    got = _extractor()._noise_floor_device(
        lambda: iter([torch.from_numpy(y[:100]), torch.from_numpy(y[100:])]))
    np.testing.assert_array_equal(got, np.median(y, axis=0))


def test_noise_floor_residency_cap_and_empty_streams():
    ext = _extractor()
    ext._NF_RESIDENT_CAP_BYTES = 64
    one = lambda: iter([torch.ones((16, M))])  # noqa: E731
    assert ext._noise_floor_device(one) is None
    assert ext._noise_floor_device(one, est_bytes=65) is None
    with pytest.raises(ValueError, match="empty sample stream"):
        _extractor()._noise_floor_device(lambda: iter(()))
    with pytest.raises(ValueError, match="empty sample stream"):
        _extractor().measure_noise_floor(lambda: iter(()))


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
