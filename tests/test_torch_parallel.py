"""The port's sharded pipeline (``sdr_channelizer_tpu_torch.parallel``): its
oracle routes against the JAX package's ``ShardedPipeline``,
``sharded_channelize`` and ``sharded_extract_pdws`` on the same mesh shapes
and inputs, against the port's own single-device pipeline (the invariant:
sharded PDWs are the unsharded ones), the stitching rules at shard
boundaries, the mesh, the merge, and ``pdw --shards`` against the JAX CLI.

The port's meshes are ``devices=["cpu"] * k``; the JAX meshes use the eight
virtual CPU devices that ``conftest.py`` sets up.
"""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu import config as jconfig
from sdr_channelizer_tpu.cli.main import main as jmain
from sdr_channelizer_tpu.dsp.channelizer import Channelizer as JChannelizer
from sdr_channelizer_tpu.dsp.pdw import extract_pdws as jextract_pdws
from sdr_channelizer_tpu.io import iqpacket
from sdr_channelizer_tpu.parallel import make_mesh as jmake_mesh
from sdr_channelizer_tpu.parallel.pipeline import (
    ShardedPipeline as JShardedPipeline,
    merge_block_batches as jmerge_block_batches,
    sharded_channelize as jsharded_channelize,
    sharded_extract_pdws as jsharded_extract_pdws,
)
from sdr_channelizer_tpu.signal.synth import PulseTrainSpec, pulse_train
from sdr_channelizer_tpu_torch import config as tconfig
from sdr_channelizer_tpu_torch.cli.main import main as tmain
from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer, channelize
from sdr_channelizer_tpu_torch.dsp.pdw import PdwBatch, extract_pdws
from sdr_channelizer_tpu_torch.models import ChannelizerPipeline
from sdr_channelizer_tpu_torch.parallel import ShardedPipeline, make_mesh
from sdr_channelizer_tpu_torch.parallel.pipeline import (
    merge_block_batches,
    sharded_channelize,
    sharded_extract_pdws,
)
from torch_port_fixtures import PDW_FIELDS

torch.set_num_threads(1)

M = 8
FS = 8e6
CFG = jconfig.PdwConfig.channelized(max_pulses=64, max_pulse_samples=128)
MESHES = [(1, 1), (2, 1), (4, 1), (8, 1), (2, 2)]


def _capture(m=M, n_frames=1024, seed=3) -> np.ndarray:
    """The two-emitter capture of ``test_parallel_fused.py``: pulses that
    straddle the 2-, 4- and 8-way shard boundaries; complex64."""
    n = n_frames * m
    fs = m * 1e6
    dur = n / fs
    specs = [
        PulseTrainSpec(sample_rate_sps=fs, duration_sec=dur,
                       frequency_hz=1.02e6, pulse_width_sec=40e-6,
                       pri_sec=110e-6, start_index=37),
        PulseTrainSpec(sample_rate_sps=fs, duration_sec=dur,
                       frequency_hz=-2.97e6, pulse_width_sec=80e-6,
                       pri_sec=270e-6, start_index=803),
    ]
    rng = np.random.default_rng(seed)
    iq = sum(pulse_train(s) for s in specs)
    iq = iq + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return iq.astype(np.complex64)


def _tmesh(n_time, n_chan):
    return make_mesh(n_time=n_time, n_chan=n_chan, devices=["cpu"] * 8)


def _pipes(n_time, n_chan, cfg=CFG, m=M, **kw):
    """The JAX sharded pipeline and the port's, built from the JAX one's
    values, on meshes of one shape."""
    jchan = JChannelizer.create(m)
    jpipe = JShardedPipeline(jmake_mesh(n_time=n_time, n_chan=n_chan), jchan,
                             cfg, **kw)
    tpipe = ShardedPipeline.from_reference(
        np.asarray(jchan.taps_rev), dataclasses.asdict(cfg),
        _tmesh(n_time, n_chan), **kw)
    return jpipe, tpipe


def _host(batch):
    return {f: np.asarray(getattr(batch, f)) for f in PDW_FIELDS}


def _assert_batches_close(got, ref):
    """Stacked batches: integers exact, the floats at the JAX package's bars
    between its routes (``test_planes.py``), NaN where the other is NaN."""
    got, ref = _host(got), _host(ref)
    assert int(ref["count"].sum()) > 10
    for f in ("toa_idx", "te_idx", "saturated", "valid", "count"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    np.testing.assert_allclose(got["pw_sec"], ref["pw_sec"], rtol=1e-6)
    np.testing.assert_allclose(got["mag"], ref["mag"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["snr_db"], ref["snr_db"], atol=1e-3)
    np.testing.assert_array_equal(np.isnan(got["freq_offset_hz"]),
                                  np.isnan(ref["freq_offset_hz"]))
    # 50 Hz at the decimated rate, in cycles per sample
    np.testing.assert_allclose(got["freq_offset_hz"], ref["freq_offset_hz"],
                               atol=50.0 / (FS / M))


def _sorted(d):
    order = np.lexsort((d["channel"], d["toa"]))
    return {k: np.asarray(v)[order] for k, v in d.items()}


def _assert_pdws_close(got, ref):
    got, ref = _sorted(got), _sorted(ref)
    assert len(got["toa"]) == len(ref["toa"]) > 0
    for key in ("toa", "channel", "sat"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_allclose(got["pw"], ref["pw"], rtol=1e-6)
    np.testing.assert_allclose(got["mag"], ref["mag"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["snr"], ref["snr"], atol=1e-3)
    ok = ~(np.isnan(got["freq"]) & np.isnan(ref["freq"]))
    np.testing.assert_allclose(got["freq"][ok], ref["freq"][ok], atol=50.0)


@pytest.fixture(scope="module")
def capture():
    return _capture()


# ----------------------------------------------------------- channelizer

@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_sharded_channelize_matches_jax(capture, mesh_shape):
    jchan = JChannelizer.create(M)
    ref = jsharded_channelize(jnp.asarray(capture), jchan,
                              jmake_mesh(*mesh_shape))
    got = sharded_channelize(capture, Channelizer.from_taps(jchan.taps_rev),
                             _tmesh(*mesh_shape))
    assert got.shape == (len(capture) // M, M)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_sharded_channelize_one_column_is_the_oracle_bit_for_bit(capture):
    chan = Channelizer.create(M)
    ref = channelize(capture, chan, device="cpu")
    for n_time in (2, 8):
        got = sharded_channelize(capture, chan, _tmesh(n_time, 1))
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


# ------------------------------------------------------ the oracle steps

@pytest.mark.parametrize("mesh_shape", MESHES)
def test_step_matches_jax(capture, mesh_shape):
    jpipe, tpipe = _pipes(*mesh_shape)
    y_r, nf_r, ref = jpipe.step(jnp.asarray(capture))
    y, nf, got = tpipe.step(capture)
    assert got.toa_idx.shape == (mesh_shape[0], M, CFG.max_pulses)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(nf.numpy(), np.asarray(nf_r), rtol=1e-5)
    _assert_batches_close(got, ref)


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_step_planes_matches_jax(capture, mesh_shape):
    jpipe, tpipe = _pipes(*mesh_shape)
    xr = np.ascontiguousarray(capture.real)
    xi = np.ascontiguousarray(capture.imag)
    yr_r, yi_r, nf_r, ref = jpipe.step_planes(jnp.asarray(xr), jnp.asarray(xi))
    yr, yi, nf, got = tpipe.step_planes(xr, xi)
    np.testing.assert_allclose(yr.numpy(), np.asarray(yr_r), atol=1e-5)
    np.testing.assert_allclose(yi.numpy(), np.asarray(yi_r), atol=1e-5)
    # the planes' products round differently in torch and XLA: the floor
    # at the planes' bar (``test_planes.py``: atol 1e-6)
    np.testing.assert_allclose(nf.numpy(), np.asarray(nf_r), rtol=1e-5,
                               atol=1e-6)
    _assert_batches_close(got, ref)


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_extract_and_extract_planes_match_jax(capture, mesh_shape):
    jpipe, tpipe = _pipes(*mesh_shape)
    kw = dict(fs=FS, fc=1e9, sample_start_time=2.0)
    _assert_pdws_close(tpipe.extract(capture, **kw),
                       jpipe.extract(jnp.asarray(capture), **kw))
    _assert_pdws_close(tpipe.extract_planes(capture, **kw),
                       jpipe.extract_planes(capture, **kw))


@pytest.mark.parametrize("n_time", [2, 4, 8])
def test_step_one_column_is_the_single_device_oracle(capture, n_time):
    """With one mesh column the sharded oracle step gives the port's
    single-device oracle step's PDWs bit for bit (the FFT path)."""
    single = ChannelizerPipeline(Channelizer.create(M), CFG, "cpu")
    _, nf_r, ref = single.forward(capture)
    pipe = ShardedPipeline(_tmesh(n_time, 1), single.channelizer, CFG)
    _, nf, got = pipe.step(capture)
    np.testing.assert_array_equal(nf.numpy(), nf_r.numpy())
    merged = merge_block_batches(got, len(capture) // (n_time * M))
    for ch in range(M):
        g, r = _valid(merged, ch), _valid(ref, ch)
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)


def _valid(batch, ch):
    """Sorted (toa, te, pw, mag, snr, foff, sat) of one channel."""
    v = np.asarray(batch.valid[ch])
    cols = [np.asarray(f[ch])[v] for f in (
        batch.toa_idx, batch.te_idx, batch.pw_sec, batch.mag, batch.snr_db,
        batch.freq_offset_hz, batch.saturated)]
    order = np.argsort(cols[0], kind="stable")
    return [c[order] for c in cols]


def test_from_reference_carries_the_parameters_across():
    jpipe, tpipe = _pipes(2, 2, halo_frames=96, halo_mode="strict")
    np.testing.assert_array_equal(tpipe.channelizer.taps_rev,
                                  np.asarray(jpipe.channelizer.taps_rev))
    assert dataclasses.asdict(tpipe.pdw_cfg) == dataclasses.asdict(CFG)
    assert (tpipe.halo_frames, tpipe.halo_mode) == (96, "strict")
    assert (tpipe.n_time, tpipe.n_chan) == (2, 2)


# ------------------------------------------------- stitching behaviour

def test_boundary_straddling_pulse_owned_once():
    """One long pulse over frames [500, 1600) crosses the boundaries of an
    8-way split of 2048 frames; it is emitted once, by the shard owning its
    leading edge, and the halo capped to the block warns."""
    n_frames = 2048
    n = n_frames * M
    iq = np.full(n, 0.001 + 0j, np.complex64)
    tone = np.exp(2j * np.pi * 1.1e6 / FS * np.arange(n)).astype(np.complex64)
    iq[500 * M:1600 * M] = tone[500 * M:1600 * M]
    cfg = jconfig.PdwConfig.channelized(max_pulses=16, max_pulse_samples=2048)
    single = ChannelizerPipeline(Channelizer.create(M), cfg, "cpu")
    _, _, ref = single.forward(iq)
    pipe = ShardedPipeline(_tmesh(8, 1), single.channelizer, cfg)
    with pytest.warns(UserWarning, match="halo"):
        _, _, got = pipe.step(iq)
    merged = merge_block_batches(got, n_frames // 8)
    assert int(got.count.sum()) == int(ref.count.sum()) >= 1
    for ch in range(M):
        for a, b in zip(_valid(merged, ch), _valid(ref, ch)):
            np.testing.assert_array_equal(a, b)


def test_pulse_active_at_end_not_emitted():
    """The reference rule holds under sharding (the +inf halo pad)."""
    n = 1024 * M
    iq = np.full(n, 0.001 + 0j, np.complex64)
    tone = np.exp(2j * np.pi * 1.0e6 / FS * np.arange(n)).astype(np.complex64)
    iq[900 * M:] = tone[900 * M:]  # runs to the capture's end
    cfg = jconfig.PdwConfig.channelized(max_pulses=8, max_pulse_samples=256)
    single = ChannelizerPipeline(Channelizer.create(M), cfg, "cpu")
    _, _, ref = single.forward(iq)
    pipe = ShardedPipeline(_tmesh(8, 1), single.channelizer, cfg)
    with pytest.warns(UserWarning, match="halo"):
        _, _, got = pipe.step(iq)
    assert int(got.count.sum()) == int(ref.count.sum())
    merged = merge_block_batches(got, 1024 // 8)
    for ch in range(M):
        for a, b in zip(_valid(merged, ch), _valid(ref, ch)):
            np.testing.assert_array_equal(a, b)
    # what is emitted closed inside the capture; the tone's pulse never does
    assert int(merged.te_idx[merged.valid].max()) < 1024
    assert not (merged.toa_idx[merged.valid] >= 890).any() or \
        int((merged.toa_idx[merged.valid] >= 890).sum()) == int(
            (ref.toa_idx[ref.valid] >= 890).sum())


def test_strict_halo_refuses_and_warn_warns():
    iq = _capture()
    cfg = jconfig.PdwConfig.channelized(max_pulses=8, max_pulse_samples=2048)
    chan = Channelizer.create(M)
    mesh = _tmesh(8, 1)
    with pytest.raises(ValueError, match="halo"):
        ShardedPipeline(mesh, chan, cfg, halo_mode="strict").step(iq)
    with pytest.warns(UserWarning, match="capping to 128"):
        ShardedPipeline(mesh, chan, cfg).step(iq)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, _, batch = ShardedPipeline(mesh, chan, cfg, halo_frames=128,
                                      halo_mode="strict").step(iq)
    assert int(batch.count.sum()) > 0
    with pytest.raises(ValueError, match="halo_mode"):
        ShardedPipeline(mesh, chan, cfg, halo_mode="loud").step(iq)


# ---------------------------------------------------------- wideband

def _wideband_capture():
    n = 8 * 4096
    rng = np.random.default_rng(11)
    iq = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    tone = np.exp(2j * np.pi * 0.113 * np.arange(n)).astype(np.complex64)
    for s in range(500, n - 700, 3000):  # pulses straddle 4096-sample shards
        iq[s:s + 700] = tone[s:s + 700]
    return iq


def test_sharded_wideband_matches_jax_and_the_single_device():
    iq = _wideband_capture()
    cfg = jconfig.PdwConfig.wideband(max_pulses=32, max_pulse_samples=1024)
    ref, block_r = jsharded_extract_pdws(jnp.asarray(iq), cfg,
                                         jmake_mesh(n_time=4, n_chan=1))
    got, block = sharded_extract_pdws(iq, cfg, _tmesh(4, 1))
    assert block == block_r == len(iq) // 4
    assert got.toa_idx.shape == (4, 1, cfg.max_pulses)
    g, r = _host(got), _host(ref)
    for f in ("toa_idx", "te_idx", "pw_sec", "saturated", "valid", "count"):
        np.testing.assert_array_equal(g[f], r[f], err_msg=f)
    # torch's and XLA's magnitude, angle and log10 differ in the last place
    # (the bars of ``test_torch_wideband.py``)
    np.testing.assert_allclose(g["mag"], r["mag"], rtol=2e-7, atol=0)
    np.testing.assert_allclose(g["snr_db"], r["snr_db"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(g["freq_offset_hz"], r["freq_offset_hz"],
                               rtol=3e-7, atol=1e-9)
    # the invariant: the merged PDWs are the single-device extractor's
    one = extract_pdws(torch.as_tensor(iq), cfg, stats="pallas")
    merged = merge_block_batches(got, block)
    v = merged.valid[0]
    n_one = int(one.count)
    assert int(merged.count[0]) == n_one > 5
    np.testing.assert_array_equal(np.sort(merged.toa_idx[0][v]),
                                  one.toa_idx[:n_one].numpy())
    ref_one = jextract_pdws(jnp.asarray(iq), cfg)
    assert int(ref_one.count) == n_one


def test_sharded_wideband_refuses_a_chan_axis():
    with pytest.raises(ValueError, match=r"\(n_time, 1\)"):
        sharded_extract_pdws(_wideband_capture(), tconfig.PdwConfig.wideband(),
                             _tmesh(2, 2))


# ------------------------------------------------------ mesh and merge

def test_merge_block_batches_matches_jax():
    rng = np.random.default_rng(5)
    nt, m, p = 3, 4, 6
    valid = rng.random((nt, m, p)) < 0.6
    batch = dict(
        toa_idx=np.where(valid, rng.integers(0, 100, (nt, m, p)), -1
                         ).astype(np.int32),
        te_idx=np.where(valid, rng.integers(100, 200, (nt, m, p)), -1
                        ).astype(np.int32),
        pw_sec=rng.random((nt, m, p)).astype(np.float32),
        mag=rng.random((nt, m, p)).astype(np.float32),
        snr_db=rng.random((nt, m, p)).astype(np.float32),
        freq_offset_hz=rng.random((nt, m, p)).astype(np.float32),
        saturated=rng.random((nt, m, p)) < 0.3, valid=valid,
        count=valid.sum(-1).astype(np.int32))
    from sdr_channelizer_tpu.dsp.pdw import PdwBatch as JPdwBatch

    ref = jmerge_block_batches(JPdwBatch(**batch), 1000)
    for got in (merge_block_batches(PdwBatch(**batch), 1000),
                merge_block_batches(PdwBatch(**{
                    k: torch.as_tensor(v) for k, v in batch.items()}), 1000)):
        for f in PDW_FIELDS:
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f)


def test_make_mesh_layout_and_refusals():
    mesh = make_mesh(n_chan=2, devices=["cpu"] * 6)
    assert mesh.shape == {"time": 3, "chan": 2}
    assert mesh.local_shards == [(i, j) for i in range(3) for j in range(2)]
    assert mesh.device((2, 1)) == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        make_mesh(n_time=4, n_chan=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(n_chan=4, devices=["cpu"] * 6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            make_mesh(n_time=2)


def test_exchanges_in_one_process():
    mesh = make_mesh(n_time=4, n_chan=2, devices=["cpu"] * 8)
    parts = {s: torch.full((3,), float(10 * s[0] + s[1]))
             for s in mesh.local_shards}
    right = mesh.send_right(parts)
    left = mesh.send_left(parts)
    for i, j in mesh.local_shards:
        assert (right[(i, j)] is None) == (i == 0)
        assert (left[(i, j)] is None) == (i == 3)
        if i:
            assert torch.equal(right[(i, j)], parts[(i - 1, j)])
        if i < 3:
            assert torch.equal(left[(i, j)], parts[(i + 1, j)])
    gathered = mesh.gather_time(parts)
    assert sorted(gathered) == [0, 1]
    for j, col in gathered.items():
        assert [float(c[0]) for c in col] == [10.0 * i + j for i in range(4)]


def test_sharding_and_pipeline_configs_match_jax():
    for name in ("ShardingConfig", "PipelineConfig"):
        jf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(jconfig, name))]
        tf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(tconfig, name))]
        assert [n for n, _ in tf] == [n for n, _ in jf]
    assert dataclasses.asdict(tconfig.ShardingConfig()) == \
        dataclasses.asdict(jconfig.ShardingConfig())
    pc = tconfig.PipelineConfig(tconfig.ChannelizerConfig(8))
    assert pc.pdw == tconfig.PdwConfig.channelized()
    assert pc.sharding.pdw_halo_frames == 4096


# ------------------------------------------------------------------ CLI

@pytest.fixture(scope="module")
def cli_capture(tmp_path_factory):
    """12-bit ``.iq`` captures at 8 Msps: the two emitters (channelized)
    and the wideband pulses."""
    d = tmp_path_factory.mktemp("cli")
    for name, iq in (("cap", _capture(n_frames=1024, seed=9)),
                     ("wide", _wideband_capture())):
        hdr = iqpacket.IqHeader(frequency_hz=1e9, bandwidth_hz=FS,
                                sample_rate_sps=FS, rx_gain_db=0,
                                num_samples=len(iq), bit_width=12,
                                sample_start_time=100.0)
        iqpacket.write_iq(str(d / f"{name}.iq"), hdr,
                          iqpacket.from_complex(iq, 12))
    return d, str(d / "cap.iq")


@pytest.mark.parametrize("channelized", [True, False])
def test_cli_pdw_shards_matches_the_jax_cli(cli_capture, channelized):
    d, path = cli_capture
    if not channelized:
        path = str(d / "wide.iq")
    extra = ["--channelized"] if channelized else []
    common = [path, "--shards", "4", "--max-pulses", "64",
              "--max-pulse-samples", "128"] + extra
    a, b = str(d / f"t{channelized}.npz"), str(d / f"j{channelized}.npz")
    assert tmain(["pdw", *common, "--device", "cpu", "--out", a]) == 0
    assert jmain(["pdw", *common, "--out", b]) == 0
    got, ref = np.load(a), np.load(b)
    assert sorted(got.files) == sorted(ref.files)
    _assert_pdws_close({k: got[k] for k in got.files},
                       {k: ref[k] for k in ref.files})


def test_cli_pdw_shards_on_an_int32_mat_matches_the_jax_cli(cli_capture):
    """A ``.mat`` whose raw ``iq`` is int32 is dequantized on the host and
    goes through the sharded step as float planes, scaled once: the same
    PDWs as the JAX CLI, and as the ``.iq`` it was converted from."""
    import scipy.io

    d, path = cli_capture
    assert tmain(["convert", path, "--out-dir", str(d / "mat"), "--mat",
                  "--raw"]) == 0
    mat = scipy.io.loadmat(str(d / "mat" / "cap.mat"))
    assert mat["iq"].dtype == np.int16
    mat32 = str(d / "cap32.mat")
    scipy.io.savemat(mat32, {k: (v.astype(np.int32) if k == "iq" else v)
                             for k, v in mat.items() if not k.startswith("__")})
    common = ["--channelized", "--shards", "4", "--max-pulses", "64",
              "--max-pulse-samples", "128"]
    a, b, c = (str(d / f"{x}32.npz") for x in "tjq")
    assert tmain(["pdw", mat32, *common, "--device", "cpu", "--out", a]) == 0
    assert jmain(["pdw", mat32, *common, "--out", b]) == 0
    assert tmain(["pdw", path, *common, "--device", "cpu", "--out", c]) == 0
    got = np.load(a)
    assert len(got["toa"]) > 0
    for ref in (np.load(b), np.load(c)):
        _assert_pdws_close({k: got[k] for k in got.files},
                           {k: ref[k] for k in ref.files})


def test_cli_strict_halo_refuses_where_the_halo_does_not_fit(cli_capture):
    _, path = cli_capture
    for extra in (["--channelized"], []):
        # 1024 frames over 8 shards: blocks of 128 frames, halo 4096
        with pytest.raises(ValueError, match="halo"):
            tmain(["pdw", path, "--shards", "8", "--strict-halo",
                   "--device", "cpu", "--out", os.devnull, *extra])


@pytest.mark.parametrize("trailing", [None, 3.0])
def test_block_transfer_is_the_scans_last_column(trailing):
    """``block_transfer`` (reductions) against the last column of
    ``hysteresis_fns`` (scans) on runs of sets, resets, holds and toggles,
    NaNs, rows without a set or reset, one sample, and a batch of rows."""
    from sdr_channelizer_tpu_torch.dsp import pdw as tpdw

    rng = np.random.default_rng(4)
    nf = torch.tensor([1.0, 1.0, 2.0, 0.5, 1.0, 1.0])
    for t_len in (1, 2, 7, 300):
        # levels straddling both thresholds; equal thresholds make toggles
        mag = torch.from_numpy(rng.choice(
            [0.0, 1.0, 2.0, 10.0, 40.0, 100.0, np.nan],
            size=(6, t_len)).astype(np.float32)) * nf[:, None]
        mag[4] = 2.0   # between trailing and leading: holds only
        lead = nf * 10.0 ** 1.5
        trail = lead if trailing is None else nf * 10.0 ** (trailing / 10)
        a_ref, b_ref = tpdw.hysteresis_fns(mag >= lead[:, None],
                                           mag <= trail[:, None])
        a, b = tpdw.block_transfer(mag, nf[:, None], 15.0, trailing)
        assert torch.equal(a, a_ref[:, -1]) and torch.equal(b, b_ref[:, -1])
        # a sample on both thresholds at once is a toggle
        ties = torch.full((3, t_len), 31.622776, dtype=torch.float32)
        ties[1, ::3] = 0.0  # resets among the toggles
        th = torch.full((3, 1), 31.622776)
        a_ref, b_ref = tpdw.hysteresis_fns(ties >= th, ties <= th)
        a, b = tpdw.block_transfer(ties, th, 0.0, None)
        assert torch.equal(a, a_ref[:, -1]) and torch.equal(b, b_ref[:, -1])
