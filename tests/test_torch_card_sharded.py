"""The sharded path (``parallel``) on the card, staged: a CUDA graph a
stage, key and device, the exchanges eager between the replays.

On one card, four shards on ``cuda:0``: ``ShardedPipeline.extract_fused``
on the dense and sparse captures at meshes (4, 1) and (2, 2), bit for bit
its eager form (``_eager``) and held against every pulse of the unsharded
step cut to a shard's slots; launches and captures counted; each stage's
replayed outputs against its kernels' plain versions.  K1's and B5's band
slices; route ``"cm"`` at (2, 2); wideband 16,000,000 samples at (4, 1);
the oracle steps and ``sharded_channelize`` on a quarter of the sparse
capture; ``pdw --shards 4`` in fresh processes and a ``--strict-halo``
refusal; two gloo ranks on one card.  Where the machine has several cards,
the same path a card a shard, in one process and in one NCCL process a
card (skipped with fewer than two cards).

Marked ``card``: skipped without a CUDA card.  No JAX in this file:

    python -m pytest tests/test_torch_card_sharded.py -q -p no:cacheprovider \\
        -o addopts="" --noconftest -m card
"""

import dataclasses
import os
import weakref

import numpy as np
import pytest
import torch

from sdr_channelizer_tpu_torch import bench
from torch_card_fixtures import (
    BIT_WIDTH, DEVICE, FRAMES_MAIN, FS_MAIN, M_MAIN, WIDE_FS, WIDE_SAMPLES,
    band_cols, band_parts, check, compare_flat, compare_streams,
    outputs_identical, pack, pdws_identical, read_counts, reset_counts, same,
    run_module_cli, small_capture, wideband_capture)
from torch_card_fixtures import caps, card, pipe  # noqa: F401  (fixtures)

pytestmark = pytest.mark.card

SHARD_DEVICES = 4             # the one-card tests' shards, all on cuda:0
SHARD_MESHES = ((4, 1), (2, 2))
SHARDED_COUNTS = {
    "channelize_streams_packed_cm2": "channelizer_kernel.launches",
    "noise_floor_cm": "nf_kernel.launches",
    "latch_cumsums_cm": "latch_kernel.launches",
    "pulse_stats": "pulse_stats_kernel.launches"}
SHARDED_CM_COUNTS = {
    "channelize_streams_packed": "channelizer_kernel.launches_flat",
    "noise_floor_cm": "nf_kernel.launches",
    "cm_streams": "transpose_kernel.launches",
    "latch_cumsums": "latch_kernel.launches_tm",
    "pulse_stats_dense": "pulse_stats_kernel.launches_dense"}
SHARDED_WIDE_COUNTS = {
    "noise_floor_cm": "nf_kernel.launches",
    "cm_streams": "transpose_kernel.launches",
    "latch_cumsums": "latch_kernel.launches_tm",
    "pulse_stats_dense": "pulse_stats_kernel.launches_dense"}


def shard_slots(pdws: dict, slots: int, n_time: int) -> dict:
    """``pdws`` of the whole capture (at ``sample_start_time`` 0, the main
    path's 1 MHz frame rate) cut to what a step over ``n_time`` time shards
    keeps: ``max_pulses`` is a shard's slots a channel, so of each channel
    in each shard the first ``slots`` pulses by TOA, a pulse in the shard
    of its first frame (``toa = (i0 + 1) / fs``)."""
    i0 = np.rint(pdws["toa"] * FS_MAIN / M_MAIN).astype(np.int64) - 1
    cell = (i0 // (FRAMES_MAIN // n_time)) * M_MAIN + pdws["channel"]
    keep = np.zeros(len(i0), bool)
    for c in np.unique(cell):
        idx = np.nonzero(cell == c)[0]
        keep[idx[np.argsort(pdws["toa"][idx], kind="stable")[:slots]]] = True
    return {k: v[keep] for k, v in pdws.items()}


@pytest.fixture(scope="module")
def whole(pipe, caps):
    """Every pulse of each capture, from the single-device step with slots
    a channel to spare (doubled from the widest mesh's shards times
    ``max_pulses`` until no channel fills them: the dense capture fills a
    channel's 512), which ``shard_slots`` cuts to what a sharded step
    keeps."""
    from sdr_channelizer_tpu_torch.models import ChannelizerPipeline

    out = {}
    for name, samples in caps.items():
        slots = max(nt for nt, _ in SHARD_MESHES) * pipe.pdw_cfg.max_pulses
        while True:
            big = ChannelizerPipeline(pipe.channelizer, dataclasses.replace(
                pipe.pdw_cfg, max_pulses=slots), pipe.device)
            out[name] = big.extract_fused(samples, BIT_WIDTH, fs=FS_MAIN)
            if np.bincount(out[name]["channel"]).max() < slots:
                break
            slots *= 2
    return out


def pdws_sharded_agree(a: dict, b: dict, where: str) -> None:
    """The sharded = single-device invariant: integer fields and ``mag``
    bit for bit, freq and snr within rtol 1e-9, atol 1e-5 (the bars of
    ``tests/test_parallel_fused.py``)."""
    check(len(a["toa"]) == len(b["toa"]),
          f"{where}: {len(a['toa'])} pulses vs {len(b['toa'])}")
    oa = np.lexsort((a["channel"], a["toa"]))
    ob = np.lexsort((b["channel"], b["toa"]))
    for key in ("toa", "pw", "channel", "sat", "mag"):
        check(np.array_equal(a[key][oa], b[key][ob], equal_nan=True),
              f"{where}: {key} is not bit for bit the single-device step's")
    for key in ("freq", "snr"):
        check(np.allclose(a[key][oa], b[key][ob], rtol=1e-9, atol=1e-5,
                          equal_nan=True), f"{where}: {key} differs")


def write_dwells(directory: str, samples: np.ndarray, fs: float,
                 bit_width: int, n_files: int = 4) -> None:
    """The (N, 2) integer payload ``samples`` as ``n_files`` contiguous
    ``.iq`` dwell files."""
    from sdr_channelizer_tpu_torch.io import iqpacket

    chunk = len(samples) // n_files
    for k in range(n_files):
        part = samples[k * chunk:(k + 1) * chunk]
        iqpacket.write_iq(os.path.join(directory, f"d{k}.iq"),
                          iqpacket.IqHeader(
                              frequency_hz=0, bandwidth_hz=fs,
                              sample_rate_sps=fs, rx_gain_db=0,
                              num_samples=len(part), bit_width=bit_width,
                              sample_start_time=100.0 + k * chunk / fs),
                          part)


def rows_agree(ranks: list, one: dict, where: str) -> None:
    """The ranks' rows of ``multihost.run_capture_set``, stitched in rank
    order, bit for bit the one-process rows (the floor whole on every
    rank)."""
    for key, want in one.items():
        if key.endswith(("span", "step_ms")):
            continue
        got = ranks[0][key] if key.endswith("nf") else np.concatenate(
            [z[key] for z in ranks])
        check(np.array_equal(got, want, equal_nan=True),
              f"{where}: {key} differs from one process")


def stage_counts(spipe) -> dict:
    """``{stage: (hits, misses, graphs kept)}`` of a sharded pipeline's
    staged stages, summed over devices."""
    out = {}
    for (name, _), st in spipe._staged.items():
        h, m, g = out.get(name, (0, 0, 0))
        out[name] = (h + st.hits, m + st.misses, g + len(st))
    return out


def captures_between(before: dict, after: dict) -> dict:
    """The captures (misses) each stage made between two readings of
    ``stage_counts``."""
    return {n: after[n][1] - before.get(n, (0, 0, 0))[1] for n in after}


def recorded_stages(spipe, fn) -> dict:
    """One run of ``fn`` with every stage that ``spipe`` hands out
    recorded: the last call of each, ``{stage: (args, static, outputs)}``."""
    calls = {}
    stage = spipe._stage

    def recording(name, device):
        st = stage(name, device)

        def call(*args, **static):
            out = st(*args, **static)
            calls[name] = (args, static, out)
            return out
        return call

    spipe._stage = recording
    try:
        fn()
    finally:
        del spipe._stage
    return calls


def stages_against_plain(spipe, calls: dict, where: str) -> None:
    """Each recorded stage's replayed outputs against its kernels' plain
    versions on the same inputs: K1 / B5 at the channelizer's tolerances
    (``compare_streams`` / ``compare_flat``, with the history and the band
    slice), K2's floor bit for bit, the kernel tails (K3 and K4; B8, B7 and
    K4) bit for bit.  The oracle's stages launch no kernel."""
    from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
    from sdr_channelizer_tpu_torch.ops import cuda as k

    cfg = spipe.pdw_cfg
    for name, (args, static, got) in calls.items():
        what = f"{where}, stage {name} replayed"
        if name in ("_chan_cm2", "_chan_cm"):
            f0, f1, h0 = args[:3]
            check(f1 is None, f"{what}: not a packed payload")
            m_loc = got[0].shape[0 if name == "_chan_cm2" else 1]
            band = None if spipe.n_chan == 1 else (static["col"] * m_loc,
                                                   m_loc)
            kw = dict(history=None if h0 is None else h0.reshape(-1),
                      band=band)
            if name == "_chan_cm2":
                xq = torch.cat([f0, args[4]]).reshape(-1)
                compare_streams(
                    xq, spipe.channelizer.taps_rev, static["bit_width"],
                    cfg.saturation_level, got, what, **kw)
            else:
                compare_flat(
                    f0.reshape(-1), spipe.channelizer.taps_rev,
                    static["bit_width"], cfg.saturation_level, got, what,
                    **kw)
        elif name in ("_floor_cm2", "_floor_cm", "_floor_1d"):
            if name == "_floor_cm2":
                buf = torch.cat(args, dim=1)
            elif name == "_floor_cm":
                buf = torch.cat([m.T.contiguous() for m in args], dim=1)
            else:
                buf = torch.cat(args).reshape(1, -1)
            want = k.PLAIN.noise_floor(buf, buf.shape[1]).reshape(
                got[0].shape)
            check(same(got[0], want), f"{what}: the floor is not K2's plain "
                                      f"version's")
        elif name == "_tail_cm2":
            mag_cm, dph_cm, satcs_cm, nf, entry, row = args
            own = static["own_len"]
            cols = torch.arange(mag_cm.shape[1], device=mag_cm.device)
            latch = torch.where((row == spipe.n_time - 1) & (cols >= own),
                                float("inf"), mag_cm)
            outputs_identical(got, pdwmod._extract_channelized_cm2(
                mag_cm, dph_cm, satcs_cm, cfg, nf, mag_cm.shape[1],
                mag_cm.shape[0], ops=k.PLAIN, entry_active=entry,
                own_len=own, mag_latch_cm=latch), f"{what}: vs plain K3, K4")
        elif name == "_tail_tm" and static["kernel"]:
            mag, ph, sat, hm, hp, hs, nf, entry, row = args
            hm = torch.where(row == spipe.n_time - 1, float("inf"), hm)
            outputs_identical(got, pdwmod._extract_channelized_pallas_stats(
                torch.cat([mag, hm]), torch.cat([ph, hp]),
                torch.cat([sat, hs]).to(torch.bool), cfg, nf,
                entry_active=entry, own_len=static["own_len"], ops=k.PLAIN),
                f"{what}: vs plain B8, B7, K4")


def one_card_devices():
    return [torch.device(DEVICE, 0)] * SHARD_DEVICES


@pytest.mark.parametrize("nt,nc", SHARD_MESHES, ids=["4x1", "2x2"])
def test_sharded_extract_fused(pipe, caps, whole, nt, nc):
    """``extract_fused`` at (nt, nc) on four shards of one card, the first
    capture capturing each key once and the second none; K1 and K3 once a
    shard, K2 once a mesh column (plus each capture's warm-up); the PDWs
    those of the unsharded step cut to a shard's slots, bit for bit the
    eager form's; on the dense capture each stage's replay against its
    kernels' plain versions."""
    from sdr_channelizer_tpu_torch.parallel import ShardedPipeline, make_mesh

    key = f"{nt}x{nc}"
    dev = torch.device(DEVICE, 0)
    spipe = ShardedPipeline(make_mesh(nt, nc, devices=one_card_devices()),
                            pipe.channelizer, pipe.pdw_cfg)
    for name, samples in caps.items():   # the first one captures
        reset_counts(SHARDED_COUNTS)
        before = stage_counts(spipe)
        got = spipe.extract_fused(samples, BIT_WIDTH, fs=FS_MAIN)
        torch.cuda.synchronize()
        counts = read_counts(SHARDED_COUNTS)
        made = captures_between(before, stage_counts(spipe))
        keys = {"_chan_cm2": 2 * nc, "_floor_cm2": 1, "_tail_cm2": 1}
        check(made == (keys if name == next(iter(caps)) else
                       dict.fromkeys(keys, 0)),
              f"sharded {key} {name}: captures {made}, want each key "
              f"once on the first step and none after")
        check(counts["channelize_streams_packed_cm2"]
              == nt * nc + made["_chan_cm2"]
              and counts["latch_cumsums_cm"] == nt * nc
              + made["_tail_cm2"]
              and counts["noise_floor_cm"] == nc + made["_floor_cm2"]
              and counts["pulse_stats"] > 0,
              f"sharded {key} {name}: launch counts {counts}")
        pdws_sharded_agree(got, shard_slots(
            whole[name], pipe.pdw_cfg.max_pulses, nt),
            f"sharded {key} {name}")
        spipe._eager = True
        try:
            eager = spipe.extract_fused(samples, BIT_WIDTH, fs=FS_MAIN)
        finally:
            spipe._eager = False
        pdws_identical(got, eager, f"sharded {key} {name}: staged vs eager")
        if name == "dense":
            xq = torch.as_tensor(pack(samples), device=dev)
            stages_against_plain(
                spipe, recorded_stages(spipe, lambda: spipe.step_packed(
                    xq, BIT_WIDTH)), f"sharded {key} {name}")


def test_band_slices(pipe, caps):
    """K1 and B5 with a band slice against their plain versions and, bit
    for bit, against the full matrix's bands: at the main shape with the
    halves of M = 64, at M = 20 with slices of 10 (and one of 7 from band
    3), and with T one frame either side of a tile boundary (7439, 7440,
    7441 frames, tiles of 15 and 63 frames)."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.ops import cuda as k

    dev = torch.device(DEVICE, 0)
    xq = torch.as_tensor(pack(caps["dense"]), device=dev)
    level = pipe.pdw_cfg.saturation_level
    taps = pipe.channelizer.taps_rev
    m = M_MAIN
    full = k.channelize_streams_packed_cm2(xq, taps, BIT_WIDTH, level)
    flat = k.channelize_streams_packed(xq, taps, BIT_WIDTH, level)
    for band in ((0, m // 2), (m // 2, m // 2)):
        wp, cols = band_parts(m, band), band_cols(band)
        got = k.channelize_streams_packed_cm2(xq, taps, BIT_WIDTH, level,
                                              w_parts=wp)
        torch.cuda.synchronize()
        compare_streams(xq, taps, BIT_WIDTH, level, got,
                        f"K1 band {band} main shape", band=band)
        check(all(same(a[cols], b) for a, b in zip(full, got)),
              f"K1 band {band} main shape: not the full kernel's rows")
        got = k.channelize_streams_packed(xq, taps, BIT_WIDTH, level,
                                          w_parts=wp)
        torch.cuda.synchronize()
        compare_flat(xq, taps, BIT_WIDTH, level, got,
                     f"B5 band {band} main shape", band=band)
        check(all(same(a[:, cols], b) for a, b in zip(flat, got)),
              f"B5 band {band} main shape: not the full kernel's columns")
        del got
    del full, flat, xq

    for mm, frames, bands in ((20, 777, ((0, 10), (10, 10), (3, 7))),
                              (64, 7439, ((32, 32), (5, 13))),
                              (64, 7440, ((32, 32), (5, 13))),
                              (64, 7441, ((32, 32), (5, 13)))):
        ch_taps = Channelizer.create(mm).taps_rev
        xs = torch.as_tensor(pack(small_capture(mm, frames, 12, seed=mm)),
                             device=dev)
        for ft in (None, 15, 63):
            whole_k1 = k.channelize_streams_packed_cm2(xs, ch_taps, 12, level,
                                                       tile_frames=ft)
            wflat = k.channelize_streams_packed(
                xs, ch_taps, 12, level,
                tile_frames=None if ft is None else ft + 1)
            for band in bands:
                where = f"M={mm} T={frames} tile={ft} band={band}"
                wp, cols = band_parts(mm, band), band_cols(band)
                got = k.channelize_streams_packed_cm2(
                    xs, ch_taps, 12, level, tile_frames=ft, w_parts=wp)
                gflat = k.channelize_streams_packed(
                    xs, ch_taps, 12, level, w_parts=wp,
                    tile_frames=None if ft is None else ft + 1)
                torch.cuda.synchronize()
                compare_streams(xs, ch_taps, 12, level, got, "K1 " + where,
                                band=band)
                check(all(same(a[cols], b) for a, b in zip(whole_k1, got)),
                      f"K1 {where}: not the full kernel's rows")
                compare_flat(xs, ch_taps, 12, level, gflat, "B5 " + where,
                             band=band)
                check(all(same(a[:, cols], b) for a, b in zip(wflat, gflat)),
                      f"B5 {where}: not the full kernel's columns")


def test_route_cm_2x2(pipe, caps):
    """Route ``"cm"`` at (2, 2) on the sparse capture: B5 with its band
    slice; each key captured once, none on the second step; staged bit for
    bit eager; the merged PDWs against the single-device flat route; each
    stage's replay against its kernels' plain versions."""
    from sdr_channelizer_tpu_torch.parallel import ShardedPipeline, make_mesh

    dev = torch.device(DEVICE, 0)
    fs = FS_MAIN
    spipe = ShardedPipeline(make_mesh(2, 2, devices=one_card_devices()),
                            pipe.channelizer, pipe.pdw_cfg)
    xq = torch.as_tensor(pack(caps["sparse"]), device=dev)
    reset_counts(SHARDED_CM_COUNTS)
    batches = [spipe.step_packed(xq, BIT_WIDTH, route="cm")]
    torch.cuda.synchronize()
    counts = read_counts(SHARDED_CM_COUNTS)
    made = captures_between({}, stage_counts(spipe))
    check(made == {"_chan_cm": 4, "_floor_cm": 1, "_tail_tm": 1},
          f"sharded route cm: captures {made}")
    check(counts["channelize_streams_packed"] == 4 + made["_chan_cm"]
          and counts["cm_streams"] == 4 + made["_tail_tm"]
          and counts["latch_cumsums"] == 4 + made["_tail_tm"]
          and counts["noise_floor_cm"] == 2 + made["_floor_cm"]
          and counts["pulse_stats_dense"] > 0,
          f"sharded route cm: launch counts {counts}")
    before = stage_counts(spipe)
    batches.append(spipe.step_packed(xq, BIT_WIDTH, route="cm"))
    check(captures_between(before, stage_counts(spipe))
          == dict.fromkeys(made, 0),
          "sharded route cm: the second step captured")
    spipe._eager = True
    try:
        outputs_identical(batches[1], spipe.step_packed(xq, BIT_WIDTH,
                                                        route="cm"),
                          "sharded route cm: staged vs eager")
    finally:
        spipe._eager = False
    outputs_identical(batches[0], batches[1], "sharded route cm: two steps")
    got = spipe._finalize_merged(batches[0][1], FRAMES_MAIN // 2, fs, 0.0,
                                 0.0)
    _, _, ref = pipe.forward_packed(xq, BIT_WIDTH, route="flat")
    pdws_sharded_agree(got, pipe._finalize(ref, fs, 0.0, 0.0),
                       "sharded route cm (2, 2) sparse")
    stages_against_plain(spipe, recorded_stages(
        spipe, lambda: spipe.step_packed(xq, BIT_WIDTH, route="cm")),
        "sharded route cm")


def test_wideband_4x1(card):
    """Wideband, 16,000,000 samples at (4, 1): each stage captured once,
    none on the second step; staged bit for bit eager; the merged PDWs
    those of ``WidebandPdwPipeline.extract``; each stage's replay against
    its kernels' plain versions; the kept pipeline and its graphs gone
    with the mesh, no collector run."""
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp.pdw import finalize_pdws
    from sdr_channelizer_tpu_torch.models import WidebandPdwPipeline
    from sdr_channelizer_tpu_torch.parallel import make_mesh
    from sdr_channelizer_tpu_torch.parallel.pipeline import (
        _wideband_pipeline, merge_block_batches, sharded_extract_pdws)

    dev = torch.device(DEVICE, 0)
    cfg = PdwConfig.wideband(max_pulses=512, max_pulse_samples=4096)
    wpipe = WidebandPdwPipeline.from_reference(dataclasses.asdict(cfg),
                                               DEVICE)
    _, wide_iq = wideband_capture(WIDE_SAMPLES, 1e-3, 1234, seed=3)
    ref = wpipe.extract(wide_iq, fs=WIDE_FS, sample_start_time=100.0)
    mesh = make_mesh(4, 1, devices=one_card_devices())
    x = torch.as_tensor(wide_iq, device=dev)
    reset_counts(SHARDED_WIDE_COUNTS)
    batch, block = sharded_extract_pdws(x, cfg, mesh)
    torch.cuda.synchronize()
    counts = read_counts(SHARDED_WIDE_COUNTS)
    spipe = _wideband_pipeline(mesh, cfg)
    made = captures_between({}, stage_counts(spipe))
    check(made == {"_prep_wideband": 1, "_floor_1d": 1, "_tail_tm": 1},
          f"sharded wideband: captures {made}")
    check(counts["noise_floor_cm"] == 1 + made["_floor_1d"]
          and counts["cm_streams"] == 4 + made["_tail_tm"]
          and counts["latch_cumsums"] == 4 + made["_tail_tm"]
          and counts["pulse_stats_dense"] > 0,
          f"sharded wideband: launch counts {counts}")
    before = stage_counts(spipe)
    again, _ = sharded_extract_pdws(x, cfg, mesh)
    check(captures_between(before, stage_counts(spipe))
          == dict.fromkeys(made, 0),
          "sharded wideband: the second step captured")
    outputs_identical(again, batch, "sharded wideband: two steps")
    spipe._eager = True
    try:
        outputs_identical(sharded_extract_pdws(x, cfg, mesh)[0], batch,
                          "sharded wideband: staged vs eager")
    finally:
        spipe._eager = False
    got = finalize_pdws(merge_block_batches(batch, block), fs=WIDE_FS,
                        sample_start_time=100.0)
    check(len(got["toa"]) > 200, "sharded wideband: too few pulses")
    pdws_sharded_agree(got, ref, "sharded wideband (4, 1)")
    stages_against_plain(spipe, recorded_stages(
        spipe, lambda: sharded_extract_pdws(x, cfg, mesh)),
        "sharded wideband")
    # the kept pipeline and its graphs go with the mesh, no collector run
    kept = weakref.ref(spipe)
    del x, batch, again, spipe, mesh
    check(kept() is None, "sharded wideband: the mesh's pipeline outlived it")


def test_oracle_steps(pipe, caps):
    """The oracle routes and ``sharded_channelize`` on a quarter of the
    sparse capture (their plain PyTorch steps at full depth would take most
    of the file's time): staged bit for bit eager, nothing captured the
    second time."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.parallel import ShardedPipeline, make_mesh
    from sdr_channelizer_tpu_torch.parallel.pipeline import (
        _KEPT, sharded_channelize)

    devices = one_card_devices()
    frames = FRAMES_MAIN // 4
    iq = iqpacket.to_complex(caps["sparse"][:M_MAIN * frames], BIT_WIDTH)
    xr, xi = (np.ascontiguousarray(v, np.float32) for v in (iq.real, iq.imag))
    for nt, nc in SHARD_MESHES:
        spipe = ShardedPipeline(make_mesh(nt, nc, devices=devices),
                                pipe.channelizer, pipe.pdw_cfg)
        for label, fn in (("step", lambda: spipe.step(iq)),
                          ("step_planes", lambda: spipe.step_planes(xr, xi))):
            first = fn()
            made = stage_counts(spipe)
            second = fn()
            check(captures_between(made, stage_counts(spipe))
                  == dict.fromkeys(made, 0),
                  f"sharded {label} {nt}x{nc}: the second step captured")
            spipe._eager = True
            try:
                outputs_identical(second, fn(), f"sharded {label} {nt}x{nc}: "
                                                f"staged vs eager")
            finally:
                spipe._eager = False
            outputs_identical(first, second, f"sharded {label}: two steps")
            check(int(first[-1].count.sum()) > 0, f"sharded {label}: no "
                                                  f"pulses")
        del spipe
    mesh = make_mesh(2, 2, devices=devices)
    chan = Channelizer.from_taps(pipe.channelizer.taps_rev)
    y = sharded_channelize(iq, chan, mesh)
    spipe = _KEPT[id(mesh)][("channelize", id(chan))]
    made = stage_counts(spipe)
    check(same(sharded_channelize(iq, chan, mesh), y)
          and captures_between(made, stage_counts(spipe))
          == dict.fromkeys(made, 0),
          "sharded_channelize: the second call captured or differs")
    spipe._eager = True
    try:
        check(same(sharded_channelize(iq, chan, mesh), y),
              "sharded_channelize: staged vs eager")
    finally:
        spipe._eager = False


def test_cli_shards(pipe, caps, whole, tmp_path):
    """``pdw --shards 4`` through the CLI on the card in fresh processes,
    channelized (against the unsharded step cut to a shard's slots) and
    wideband (against ``WidebandPdwPipeline.extract``), and a
    ``--strict-halo`` refusal."""
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.models import WidebandPdwPipeline

    tmp = str(tmp_path)

    def write(name, samples, rate):
        path = os.path.join(tmp, name)
        iqpacket.write_iq(path, iqpacket.IqHeader(
            frequency_hz=0.0, bandwidth_hz=rate, sample_rate_sps=rate,
            rx_gain_db=0, num_samples=len(samples), bit_width=BIT_WIDTH,
            sample_start_time=0.0), samples)
        return path

    cfg = PdwConfig.wideband(max_pulses=512, max_pulse_samples=4096)
    wpipe = WidebandPdwPipeline.from_reference(dataclasses.asdict(cfg),
                                               DEVICE)
    sparse = write("sparse.iq", caps["sparse"], FS_MAIN)
    wide_q = bench.quantize(wideband_capture(WIDE_SAMPLES, 1e-3, 1234,
                                             seed=3)[1])
    wide = write("wide.iq", wide_q, WIDE_FS)
    a = os.path.join(tmp, "a.npz")
    r = run_module_cli(["pdw", sparse, "--channelized", "--shards", "4",
                        "--max-pulses", "512", "--max-pulse-samples",
                        "1024", "--out", a])
    check(r.returncode == 0 and "(4 shards)" in r.stdout,
          f"cli pdw --channelized --shards 4: rc {r.returncode} "
          f"{r.stderr[-400:]}")
    pdws_sharded_agree(dict(np.load(a)), shard_slots(
        whole["sparse"], pipe.pdw_cfg.max_pulses, 4),
                       "cli pdw --channelized --shards 4")
    b = os.path.join(tmp, "b.npz")
    r = run_module_cli(["pdw", wide, "--shards", "4", "--max-pulses",
                        "512", "--max-pulse-samples", "4096", "--out", b])
    check(r.returncode == 0, f"cli pdw --shards 4: rc {r.returncode} "
                             f"{r.stderr[-400:]}")
    wref = wpipe.extract(iqpacket.to_complex(wide_q, BIT_WIDTH), fs=WIDE_FS)
    pdws_sharded_agree(dict(np.load(b)), wref, "cli pdw --shards 4")
    r = run_module_cli(["pdw", sparse, "--channelized", "--shards", "4",
                        "--strict-halo", "--max-pulse-samples", "100000",
                        "--out", os.path.join(tmp, "c.npz")])
    check(r.returncode != 0 and "halo" in r.stderr
          and not os.path.exists(os.path.join(tmp, "c.npz")),
          f"cli --strict-halo did not refuse: rc {r.returncode}")


def test_two_gloo_ranks_on_one_card(card, tmp_path):
    """Two ranks on one card over gloo, the exchanges staged through the
    host and every step staged: the small capture of
    ``tests/test_torch_multihost.py``, bit for bit the one-process rows."""
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.parallel import multihost
    from sdr_channelizer_tpu_torch.signal.synth import (PulseTrainSpec,
                                                         pulse_train)

    dev = torch.device(DEVICE, 0)
    spec = PulseTrainSpec(sample_rate_sps=8e6, duration_sec=8e-3,
                          frequency_hz=1.9e6, pulse_width_sec=80e-6,
                          pri_sec=310e-6, start_index=333, noise_std=2e-3)
    job = {"channels": 8, "pdw": dataclasses.asdict(PdwConfig.channelized(
        max_pulses=32, max_pulse_samples=64)), "halo_frames": 64,
        "halo_mode": "strict",
        "runs": [{"name": "", "mesh": [8, 1], "step": "step"},
                 {"name": "cm2_", "mesh": [4, 2], "step": "packed",
                  "route": "cm2"}]}
    tmp = str(tmp_path)
    write_dwells(tmp, iqpacket.from_complex(pulse_train(spec, seed=11), 16),
                 8e6, 16)
    ranks = multihost.launch_ranks(tmp, job, [[dev] * 4] * 2,
                                   backend="gloo", timeout=300)
    one = multihost.run_capture_set(tmp, [dev] * 8, job)
    rows_agree(ranks, one, "two ranks on one card")


@pytest.fixture(scope="module")
def cards(card):
    """Every CUDA card; skips with fewer than two."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs at least two CUDA devices, have {n}")
    return [torch.device(DEVICE, i) for i in range(n)]


def test_a_card_a_shard(pipe, caps, whole, cards):
    """The sharded path where each shard has a card of its own, staged:
    one process with a mesh over every card, (n, 1) and with four (2, 2):
    ``extract_fused`` of the sparse and dense captures against the
    unsharded step (``shard_slots``) and bit for bit its eager form, each
    stage captured once a device and key."""
    from sdr_channelizer_tpu_torch.parallel import ShardedPipeline, make_mesh

    n = len(cards)
    for nt, nc in [(n, 1)] + ([(2, 2)] if n == 4 else []):
        spipe = ShardedPipeline(make_mesh(nt, nc, devices=cards),
                                pipe.channelizer, pipe.pdw_cfg)
        for name, samples in caps.items():
            reset_counts(SHARDED_COUNTS)
            before = stage_counts(spipe)
            got = spipe.extract_fused(samples, BIT_WIDTH, fs=FS_MAIN)
            counts = read_counts(SHARDED_COUNTS)
            made = captures_between(before, stage_counts(spipe))
            check(counts["channelize_streams_packed_cm2"]
                  == nt * nc + made["_chan_cm2"]
                  and counts["latch_cumsums_cm"]
                  == nt * nc + made["_tail_cm2"]
                  and (name == next(iter(caps))
                       or not any(made.values())),
                  f"{nt}x{nc} on {n} cards {name}: launch counts {counts}, "
                  f"captures {made}")
            pdws_sharded_agree(got, shard_slots(
                whole[name], pipe.pdw_cfg.max_pulses, nt),
                f"{nt}x{nc} on {n} cards, {name}")
            spipe._eager = True
            try:
                pdws_identical(got, spipe.extract_fused(
                    samples, BIT_WIDTH, fs=FS_MAIN),
                    f"{nt}x{nc} on {n} cards, {name}: staged vs eager")
            finally:
                spipe._eager = False


def test_a_nccl_process_a_card(pipe, caps, cards, tmp_path):
    """One process a card joined by NCCL (the FIR tails, the halo heads and
    the floor's inputs cross cards through it, between the replays), each
    reading its own span of the sparse capture written as four dwell
    files: the packed step at (n, 1), staged and eager, bit for bit the
    one-process rows."""
    from sdr_channelizer_tpu_torch.parallel import multihost

    n = len(cards)
    job = {"channels": M_MAIN, "pdw": dataclasses.asdict(pipe.pdw_cfg),
           "runs": [{"name": "", "mesh": [n, 1], "step": "packed"},
                    {"name": "eager_", "mesh": [n, 1], "step": "packed",
                     "eager": True}]}
    tmp = str(tmp_path)
    write_dwells(tmp, caps["sparse"], FS_MAIN, BIT_WIDTH)
    ranks = multihost.launch_ranks(tmp, job, [[d] for d in cards],
                                   backend="nccl", timeout=600)
    one = multihost.run_capture_set(tmp, cards, job)
    rows_agree(ranks, one, f"{n} NCCL processes")
    for f in multihost.FIELDS:
        check(np.array_equal(one[f], one["eager_" + f], equal_nan=True),
              f"{n} cards in one process: staged {f} is not the eager one")
