"""The sharded path's staged steps (``parallel/pipeline.py``): the JAX
package's six ``jax.jit`` sites in ``sdr_channelizer_tpu/parallel/
pipeline.py`` (``_build``, ``_build_planes``, ``_build_fused``,
``_build_fused2``, ``sharded_extract_pdws``, ``sharded_channelize``), each
cut at its exchanges into stages, a ``Staged`` a stage and device.  On the
CPU a staged stage is its function, so these tests hold what does not need
a graph:

* each site's entry point going through its stages' ``Staged`` functions
  (a recording stand-in), against the JAX package's sharded step on the
  same seeded capture (its oracle ``extract`` for the fused routes, whose
  interpret-mode JAX run is too slow here), integer fields exact and float
  fields at the bars of ``test_torch_parallel*.py``;
* the staged split against the ``_eager`` form, bit for bit;
* the keys each stage makes at meshes (4, 1), (2, 2), (8, 1) and (4, 2),
  within ``MAX_GRAPHS``, and none new on a second call;
* the free functions' pipelines kept while their mesh lives, and freed
  with it without a collector run;
* every row's latch entry from the floor stage against the JAX package's
  exclusive prefix (an all-gather and an associative scan), and the cm2
  tail stage's +inf latch by a row tensor (and by the host row of the
  eager form) against the row's own latch.

The graphs themselves are held on the card by
``tests/test_torch_card_sharded.py`` (its multi-card cases on a machine
with several cards).

Run alone: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_parallel_staged.py -q -p no:cacheprovider``.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sdr_channelizer_tpu import config as jconfig
from sdr_channelizer_tpu.dsp import pdw as jpdw
from sdr_channelizer_tpu.dsp.channelizer import Channelizer as JChannelizer
from sdr_channelizer_tpu.io import iqpacket
from sdr_channelizer_tpu.models.pipeline import (
    ChannelizerPipeline as JPipeline,
)
from sdr_channelizer_tpu.parallel import make_mesh as jmake_mesh
from sdr_channelizer_tpu.parallel.pipeline import (
    ShardedPipeline as JShardedPipeline,
    sharded_channelize as jsharded_channelize,
    sharded_extract_pdws as jsharded_extract_pdws,
)
from sdr_channelizer_tpu.signal.synth import PulseTrainSpec, pulse_train
from sdr_channelizer_tpu_torch import config as tconfig
from sdr_channelizer_tpu_torch._staging import MAX_GRAPHS, Staged
from sdr_channelizer_tpu_torch.dsp import pdw as tpdw
from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
from sdr_channelizer_tpu_torch.parallel import ShardedPipeline, make_mesh
from sdr_channelizer_tpu_torch.parallel import pipeline as tpipeline
from sdr_channelizer_tpu_torch.parallel.pipeline import (
    sharded_channelize,
    sharded_extract_pdws,
)
from torch_port_fixtures import PDW_FIELDS, packed

torch.set_num_threads(1)

N_FRAMES = 1024
CFG = jconfig.PdwConfig.channelized(max_pulses=64, max_pulse_samples=128)
WIDE_CFG = jconfig.PdwConfig.wideband(max_pulses=32, max_pulse_samples=1024)
KW = dict(fs=None, fc=1e9, sample_start_time=2.0)
FUSED_STAGES = {"cm2": {"_chan_cm2", "_floor_cm2", "_tail_cm2"},
                "cm": {"_chan_cm", "_floor_cm", "_tail_tm"}}
ORACLE_STAGES = {"_chan_oracle", "_floor_median", "_tail_tm"}


def _capture(m, seed=3) -> np.ndarray:
    """Two pulsed emitters in noise over ``N_FRAMES`` frames of ``m``
    bands, pulses straddling the 2-, 4- and 8-way shard boundaries, one
    re-opened at the capture's end (it must not be emitted); complex64."""
    n = N_FRAMES * m
    fs = m * 1e6
    specs = [
        PulseTrainSpec(sample_rate_sps=fs, duration_sec=n / fs,
                       frequency_hz=1.02e6, pulse_width_sec=40e-6,
                       pri_sec=110e-6, start_index=37),
        PulseTrainSpec(sample_rate_sps=fs, duration_sec=n / fs,
                       frequency_hz=-2.97e6, pulse_width_sec=80e-6,
                       pri_sec=270e-6, start_index=803),
    ]
    rng = np.random.default_rng(seed)
    iq = sum(pulse_train(s) for s in specs)
    iq = (iq + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    iq[-60:] = iq[37:37 + 60]
    return iq


def _wideband_capture() -> np.ndarray:
    n = 8 * 4096
    rng = np.random.default_rng(11)
    iq = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    tone = np.exp(2j * np.pi * 0.113 * np.arange(n)).astype(np.complex64)
    for s in range(500, n - 700, 3000):  # pulses straddle 4096-sample shards
        iq[s:s + 700] = tone[s:s + 700]
    return iq


def _tmesh(n_time, n_chan):
    return make_mesh(n_time, n_chan, devices=["cpu"] * 8)


def _pipe(m, mesh_shape, cfg=CFG):
    return ShardedPipeline.from_reference(
        np.asarray(JChannelizer.create(m).taps_rev), dataclasses.asdict(cfg),
        _tmesh(*mesh_shape))


class Spy:
    """Stands in for a ``Staged`` stage: records each call's graph key,
    then calls the staged function."""

    def __init__(self, staged: Staged):
        self.staged = staged
        self.keys = []

    def __call__(self, *args, **static):
        self.keys.append(self.staged.key(*args, **static))
        return self.staged(*args, **static)


def _spy(pipe) -> dict:
    """Every stage ``pipe`` hands out from now on goes through a ``Spy``:
    ``{(stage, device): Spy}``; under ``_eager`` none is handed out."""
    spies = {}
    stage = pipe._stage

    def spied(name, device):
        got = stage(name, device)
        if not isinstance(got, Staged):
            return got
        key = (name, str(device))
        if key not in spies:
            spies[key] = Spy(got)
        return spies[key]

    pipe._stage = spied
    return spies


def _names(spies) -> set:
    return {name for name, _ in spies}


def _host(batch) -> dict:
    return {f: np.asarray(getattr(batch, f)) for f in PDW_FIELDS}


def _assert_batches_close(got, ref):
    """Stacked batches: integers exact, the floats at the JAX package's bars
    between its routes (``test_torch_parallel.py``)."""
    got, ref = _host(got), _host(ref)
    assert int(ref["count"].sum()) > 10
    for f in ("toa_idx", "te_idx", "saturated", "valid", "count"):
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    np.testing.assert_allclose(got["pw_sec"], ref["pw_sec"], rtol=1e-6)
    np.testing.assert_allclose(got["mag"], ref["mag"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["snr_db"], ref["snr_db"], atol=1e-3)
    np.testing.assert_array_equal(np.isnan(got["freq_offset_hz"]),
                                  np.isnan(ref["freq_offset_hz"]))
    # 50 Hz at the decimated rate (1 MHz), in cycles per sample
    np.testing.assert_allclose(got["freq_offset_hz"], ref["freq_offset_hz"],
                               atol=50.0 / 1e6)


def _assert_pdws_close(got, ref):
    """Host PDWs against the JAX CPU oracle (``test_torch_parallel_fused.
    py``): channel and saturation exact, TOA within 1e-9 s, width rtol
    1e-6, SNR 1e-3 dB, frequency 50 Hz."""
    og = np.lexsort((got["channel"], got["toa"]))
    orf = np.lexsort((ref["channel"], ref["toa"]))
    got = {k: np.asarray(v)[og] for k, v in got.items()}
    ref = {k: np.asarray(v)[orf] for k, v in ref.items()}
    assert len(got["toa"]) == len(ref["toa"]) > 10
    for key in ("channel", "sat"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    np.testing.assert_allclose(got["toa"], ref["toa"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["pw"], ref["pw"], rtol=1e-6)
    np.testing.assert_allclose(got["snr"], ref["snr"], atol=1e-3)
    np.testing.assert_allclose(got["mag"], ref["mag"], rtol=1e-5, atol=1e-6)
    ok = ~(np.isnan(got["freq"]) & np.isnan(ref["freq"]))
    np.testing.assert_allclose(got["freq"][ok], ref["freq"][ok], atol=50.0)


def _identical(a, b):
    """Every output of two steps bit for bit: tensors, batches, tuples."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _identical(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        for f in PDW_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's runs of every site's input, once."""
    out = {}
    iq = _capture(8)
    jpipe = JShardedPipeline(jmake_mesh(n_time=4, n_chan=1),
                             JChannelizer.create(8), CFG)
    out["step"] = jpipe.step(jnp.asarray(iq))
    xr, xi = (np.ascontiguousarray(v) for v in (iq.real, iq.imag))
    jpipe = JShardedPipeline(jmake_mesh(n_time=2, n_chan=2),
                             JChannelizer.create(8), CFG)
    out["step_planes"] = jpipe.step_planes(jnp.asarray(xr), jnp.asarray(xi))
    for m in (8, 16):
        samples = np.ascontiguousarray(iqpacket.from_complex(_capture(m), 12))
        out[("oracle", m)] = JPipeline.create(m, pdw_cfg=CFG).extract(
            jnp.asarray(iqpacket.to_complex(samples, 12)),
            **dict(KW, fs=m * 1e6))
    out["wideband"] = jsharded_extract_pdws(
        jnp.asarray(_wideband_capture()), WIDE_CFG,
        jmake_mesh(n_time=4, n_chan=1))
    out["channelize"] = jsharded_channelize(
        jnp.asarray(iq), JChannelizer.create(8),
        jmake_mesh(n_time=2, n_chan=2))
    return out


# ---------------------------------------------------- the six sites

def test_step_goes_through_its_stages_and_matches_jax(jax_runs):
    """``_build`` (the oracle step): FIR and FFT, the median floor, the
    time-major oracle tail, at (4, 1)."""
    pipe = _pipe(8, (4, 1))
    spies = _spy(pipe)
    y, nf, got = pipe.step(_capture(8))
    y_r, nf_r, ref = jax_runs["step"]
    assert _names(spies) == ORACLE_STAGES
    assert len(spies[("_tail_tm", "cpu")].keys) == 4
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(nf.numpy(), np.asarray(nf_r), rtol=1e-5)
    _assert_batches_close(got, ref)


def test_step_planes_goes_through_its_stages_and_matches_jax(jax_runs):
    """``_build_planes``: the four real products with each column's DFT
    slice, at (2, 2)."""
    pipe = _pipe(8, (2, 2))
    spies = _spy(pipe)
    iq = _capture(8)
    xr, xi = (np.ascontiguousarray(v) for v in (iq.real, iq.imag))
    yr, yi, nf, got = pipe.step_planes(xr, xi)
    yr_r, yi_r, nf_r, ref = jax_runs["step_planes"]
    assert _names(spies) == ORACLE_STAGES
    assert len(spies[("_floor_median", "cpu")].keys) == 2
    np.testing.assert_allclose(yr.numpy(), np.asarray(yr_r), atol=1e-5)
    np.testing.assert_allclose(yi.numpy(), np.asarray(yi_r), atol=1e-5)
    np.testing.assert_allclose(nf.numpy(), np.asarray(nf_r), rtol=1e-5,
                               atol=1e-6)
    _assert_batches_close(got, ref)


@pytest.mark.parametrize("route,mesh_shape,m", [
    ("cm2", (4, 1), 8), ("cm2", (2, 2), 16),
    ("cm", (4, 1), 8), ("cm", (2, 2), 16)])
def test_fused_routes_go_through_their_stages_and_match_jax(
        jax_runs, route, mesh_shape, m):
    """``_build_fused2`` (route cm2) and ``_build_fused`` (route cm, its
    kernel tail): against the JAX oracle's PDWs of the same capture."""
    pipe = _pipe(m, mesh_shape)
    spies = _spy(pipe)
    samples = np.ascontiguousarray(iqpacket.from_complex(_capture(m), 12))
    _, batch = pipe.step_packed(packed(samples), 12, route=route,
                                stats="auto" if route == "cm2" else "pallas")
    assert _names(spies) == FUSED_STAGES[route]
    got = pipe._finalize_merged(batch, N_FRAMES // mesh_shape[0], m * 1e6,
                                KW["fc"], KW["sample_start_time"])
    _assert_pdws_close(got, jax_runs[("oracle", m)])


def test_wideband_goes_through_its_stages_and_matches_jax(jax_runs):
    """``sharded_extract_pdws``: the prep a shard, K2's plain version on
    the gathered magnitude, the time-major kernel tail; its pipeline kept
    with the mesh, so that a second call makes the same keys."""
    mesh = _tmesh(4, 1)
    cfg = tconfig.PdwConfig(**dataclasses.asdict(WIDE_CFG))
    pipe = tpipeline._wideband_pipeline(mesh, cfg)
    spies = _spy(pipe)
    iq = _wideband_capture()
    got, block = sharded_extract_pdws(iq, cfg, mesh)
    assert tpipeline._wideband_pipeline(mesh, cfg) is pipe
    assert _names(spies) == {"_prep_wideband", "_floor_1d", "_tail_tm"}
    keys = {k: list(s.keys) for k, s in spies.items()}
    again, _ = sharded_extract_pdws(iq, cfg, mesh)
    for k, s in spies.items():
        assert s.keys == keys[k] * 2, k
    _identical(again, got)
    ref, block_r = jax_runs["wideband"]
    assert block == block_r == len(iq) // 4
    g, r = _host(got), _host(ref)
    for f in ("toa_idx", "te_idx", "pw_sec", "saturated", "valid", "count"):
        np.testing.assert_array_equal(g[f], r[f], err_msg=f)
    assert int(r["count"].sum()) > 5
    np.testing.assert_allclose(g["mag"], r["mag"], rtol=2e-7, atol=0)
    np.testing.assert_allclose(g["snr_db"], r["snr_db"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(g["freq_offset_hz"], r["freq_offset_hz"],
                               rtol=3e-7, atol=1e-9)


def test_sharded_channelize_goes_through_its_stage_and_matches_jax(
        jax_runs):
    """``sharded_channelize``: one stage a shard, its pipeline kept with
    the mesh for the channelizer it was called with."""
    mesh = _tmesh(2, 2)
    chan = Channelizer.create(8)
    iq = _capture(8)
    first = sharded_channelize(iq, chan, mesh)
    pipe = tpipeline._KEPT[id(mesh)][("channelize", id(chan))]
    spies = _spy(pipe)
    got = sharded_channelize(iq, chan, mesh)
    assert tpipeline._KEPT[id(mesh)][("channelize", id(chan))] is pipe
    assert _names(spies) == {"_chan_oracle"}
    assert len(spies[("_chan_oracle", "cpu")].keys) == 4
    assert torch.equal(got, first)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_runs["channelize"]),
                               rtol=1e-5, atol=1e-5)


def test_free_functions_keep_a_few_pipelines_with_the_mesh():
    """The least recently used of more than ``MAX_GRAPHS`` pipelines kept
    for a mesh is dropped; an equal mesh keeps its own; ``make`` is handed
    a weak proxy of the mesh."""
    mesh = _tmesh(2, 1)
    made = []

    def make(m):
        made.append(m)
        return object()
    for k in range(MAX_GRAPHS + 1):
        tpipeline._mesh_pipeline(mesh, ("k", k), make)
    assert len(made) == MAX_GRAPHS + 1
    assert made[0].n_time == 2 and made[0] == mesh
    assert type(made[0]) is weakref.ProxyType
    kept = tpipeline._KEPT[id(mesh)]
    assert list(kept) == [("k", k) for k in range(1, MAX_GRAPHS + 1)]
    tpipeline._mesh_pipeline(mesh, ("k", 1), make)
    assert len(made) == MAX_GRAPHS + 1   # kept: no new pipeline
    assert list(kept)[-1] == ("k", 1)
    other = _tmesh(2, 1)
    assert other == mesh and id(other) not in tpipeline._KEPT


def test_dropping_the_mesh_frees_its_kept_pipelines():
    """A free function's kept pipeline holds its mesh weakly: dropping the
    mesh frees the pipeline, its ``Staged`` stages and the mesh's entry at
    once, with the collector off (device memory never runs it)."""
    cfg = tconfig.PdwConfig(**dataclasses.asdict(WIDE_CFG))
    chan = Channelizer.create(8)
    gc.collect()
    gc.disable()
    try:
        mesh = _tmesh(4, 1)
        key = id(mesh)
        batch, _ = sharded_extract_pdws(_wideband_capture(), cfg, mesh)
        sharded_channelize(_capture(8), chan, mesh)
        kept = tpipeline._KEPT[key]
        gone = [weakref.ref(p) for p in kept.values()]
        gone += [weakref.ref(st) for p in kept.values()
                 for st in p._staged.values()]
        assert len(gone) > 2 and int(batch.count.sum()) > 0
        del kept
        assert all(r() is not None for r in gone)
        del mesh
        assert key not in tpipeline._KEPT
        assert all(r() is None for r in gone)
    finally:
        gc.enable()


# -------------------------------------------------- staged vs eager

@pytest.mark.parametrize("site", ["cm2", "cm", "step", "step_planes",
                                  "wideband", "channelize"])
def test_staged_split_is_the_eager_form_bit_for_bit(site):
    """Every entry point through its stages against the ``_eager`` form,
    which calls the stages' functions and no ``Staged``: every output, bit
    for bit."""
    iq = _capture(16)
    if site == "wideband":
        mesh = _tmesh(4, 1)
        cfg = tconfig.PdwConfig(**dataclasses.asdict(WIDE_CFG))
        pipe = tpipeline._wideband_pipeline(mesh, cfg)

        def run():
            return sharded_extract_pdws(_wideband_capture(), cfg, mesh)[0]
    elif site == "channelize":
        mesh, chan = _tmesh(2, 2), Channelizer.create(16)
        sharded_channelize(iq, chan, mesh)
        pipe = tpipeline._KEPT[id(mesh)][("channelize", id(chan))]

        def run():
            return sharded_channelize(iq, chan, mesh)
    else:
        pipe = _pipe(16, (2, 2))
        samples = np.ascontiguousarray(iqpacket.from_complex(iq, 12))
        xr, xi = (np.ascontiguousarray(v) for v in (iq.real, iq.imag))

        def run():
            if site == "step":
                return pipe.step(iq)
            if site == "step_planes":
                return pipe.step_planes(xr, xi)
            return pipe.step_packed(packed(samples), 12, route=site,
                                    stats="auto" if site == "cm2"
                                    else "pallas")
    spies = _spy(pipe)
    staged = run()
    calls = sum(len(s.keys) for s in spies.values())
    assert calls > 0
    pipe._eager = True
    eager = run()
    assert sum(len(s.keys) for s in spies.values()) == calls
    pipe._eager = False
    _identical(staged, eager)


# ----------------------------------------------------------- the keys

@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2), (8, 1), (4, 2)])
def test_keys_stay_within_each_stage_cap(mesh_shape):
    """At each mesh, the cm2 step (packed and on two planes), route cm
    and the oracle step: a channelize stage makes a key a mesh column and
    one more for row 0's missing history, the floor and the tail one each;
    no step makes more keys in a stage than ``MAX_GRAPHS`` (so none
    thrashes), and a second round of the steps makes no new key."""
    n_time, n_chan = mesh_shape
    m = 16
    pipe = _pipe(m, mesh_shape)
    spies = _spy(pipe)
    iq = _capture(m)
    samples = np.ascontiguousarray(iqpacket.from_complex(iq, 12))
    xq = packed(samples)
    xr, xi = (np.ascontiguousarray(samples[:, k]) for k in (0, 1))
    steps = [lambda: pipe.step_packed(xq, 12, route="cm2"),
             lambda: pipe.step_fused(xr, xi, 12, route="cm2"),
             lambda: pipe.step_packed(xq, 12, route="cm", stats="pallas"),
             lambda: pipe.step(iq)]
    for step in steps:
        before = {k: len(s.keys) for k, s in spies.items()}
        step()
        for k, spy in spies.items():
            made = set(spy.keys[before.get(k, 0):])
            assert len(made) <= MAX_GRAPHS, (k, len(made))
    first = {k: set(s.keys) for k, s in spies.items()}
    for step in steps:
        step()
    assert {k: set(s.keys) for k, s in spies.items()} == first
    chan_keys = 2 * n_chan
    # the floor and tail of cm2 take float32 streams from either payload;
    # the time-major tail is route cm's kernel tail and the oracle's
    want = {"_chan_cm2": 2 * chan_keys, "_chan_cm": chan_keys,
            "_chan_oracle": chan_keys, "_floor_cm2": 1, "_floor_cm": 1,
            "_floor_median": 1, "_tail_cm2": 1, "_tail_tm": 2}
    assert {name: len(first[(name, "cpu")]) for name in want} == want


# ------------------------------------------------- entries and the latch

def _blocks(n_time, m_loc, t_loc, seed):
    """Owned magnitude blocks with pulses that open in one block and close
    in a later one, and blocks that hold, set or reset the latch."""
    rng = np.random.default_rng(seed)
    mag = 1e-3 * rng.random((m_loc, n_time * t_loc)).astype(np.float32)
    for c in range(m_loc):
        for _ in range(3):
            a = rng.integers(0, n_time * t_loc - 2)
            b = min(n_time * t_loc, a + rng.integers(1, 2 * t_loc))
            mag[c, a:b] = rng.choice([0.5, 0.02])
    return [np.ascontiguousarray(mag[:, i * t_loc:(i + 1) * t_loc])
            for i in range(n_time)]


@pytest.mark.parametrize("n_time,trailing", [(4, None), (8, 12.0), (2, 12.0)])
def test_floor_entries_are_the_jax_exclusive_prefix(n_time, trailing):
    """Every row's entry from the floor stage (:meth:`_entries`, a fixed
    loop in shard order) against the JAX package's: each block's
    ``block_transfer``, an all-gather, ``associative_scan`` of
    ``compose_transfer`` and the row before's prefix, row 0 inactive."""
    m_loc, t_loc = 5, 64
    cfg = dataclasses.replace(CFG, trailing_threshold_db=trailing)
    pipe = _pipe(8, (n_time, 1), cfg)
    owned = _blocks(n_time, m_loc, t_loc, seed=n_time)
    nf = np.full(m_loc, 1e-3, np.float32)
    got = pipe._entries(torch.from_numpy(nf),
                        [torch.from_numpy(b) for b in owned])
    fns = [jpdw.block_transfer(jnp.asarray(b), jnp.asarray(nf)[:, None],
                               cfg.snr_threshold_db,
                               cfg.trailing_threshold_db) for b in owned]
    ga = jnp.stack([f[0] for f in fns])
    gb = jnp.stack([f[1] for f in fns])
    pa, _ = jax.lax.associative_scan(jpdw.compose_transfer, (ga, gb), axis=0)
    for t_i in range(n_time):
        prev = jnp.take(pa, max(t_i - 1, 0), axis=0)
        want = np.asarray(jnp.where(t_i == 0, jnp.zeros((m_loc,), bool),
                                    prev))
        np.testing.assert_array_equal(got[t_i].numpy(), want, err_msg=t_i)
    assert got.any() and not got.all()


def test_cm2_tail_latch_by_a_row_tensor_is_each_rows_own():
    """The cm2 tail stage with the row as a 0-d tensor (the staged form)
    and as a host int (the eager form), for every row, against the tail
    with the row's own latch: the streams as they are, and +inf past the
    owned frames on the last row only."""
    n_time, m = 4, 8
    pipe = _pipe(m, (n_time, 1))
    samples = np.ascontiguousarray(iqpacket.from_complex(_capture(m), 12))
    t_loc = N_FRAMES // n_time
    halo = CFG.max_pulse_samples
    taps = pipe.channelizer.taps_rev
    xq = torch.from_numpy(packed(samples))
    streams = tpdw.kernels.PLAIN.channelize(
        xq[:(t_loc + halo) * m].contiguous(), taps, bit_width=12,
        sat_level=CFG.saturation_level)
    nf = tpdw.noise_floor_cm(streams[0], m, streams[0].shape[1])
    entry = torch.zeros(m, dtype=torch.bool)
    entry[[1, 5]] = True
    pulses = 0
    for i in range(n_time):
        latch = streams[0]
        if i == n_time - 1:
            latch = streams[0].clone()
            latch[:, t_loc:] = float("inf")
        want = tpdw._extract_channelized_cm2(
            *streams, CFG, nf, t_loc + halo, m, entry_active=entry,
            own_len=t_loc, mag_latch_cm=latch)
        for row in (torch.tensor(i, dtype=torch.int64), i):
            got = pipe._tail_cm2(*streams, nf, entry, row, own_len=t_loc)
            _identical(got, want)
        pulses += int(got.count.sum())
    assert pulses > 0


@pytest.mark.parametrize("start", [0, 4])
def test_past_end_is_the_same_bits_staged_and_eager(start):
    """``_past_end`` with a 0-d bool tensor (the staged form) and with a
    host bool (the eager form): the same bits on the last row and on any
    other, and the eager form hands another row's tensor itself back and
    leaves its input as it was."""
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) - 3.0
    before = x.clone()
    for last in (False, True):
        staged = tpipeline._past_end(x, torch.tensor(last), start)
        eager = tpipeline._past_end(x, last, start)
        _identical(staged, eager)
        assert (eager is x) == (not last)
        assert torch.equal(x, before)
        n_inf = int(torch.isinf(staged).sum())
        assert n_inf == (0 if not last else 4 * (6 - start))
