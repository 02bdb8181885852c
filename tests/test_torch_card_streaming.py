"""The streamed path on the card at full width: the sparse capture four
times over as four contiguous ``.iq`` files (67,108,864 samples, 16 blocks
of 65,536 frames) through ``extract_segment_fused``, held against
single-shot extraction of the same samples, its plain run and its own
resume; its staged steps (a CUDA graph a key) against the eager run in
turns, bit for bit; the floor's count passes alone, staged and eager; the
oracle forms ``extract_segment`` / ``extract`` staged and eager on one
file; and the dense capture as one file, where the slot grid with the
mask is what runs.

Marked ``card``: skipped without a CUDA card.  No JAX in this file:

    python -m pytest tests/test_torch_card_streaming.py -q -p no:cacheprovider \\
        -o addopts="" --noconftest -m card
"""

import os

import numpy as np
import pytest
import torch

from torch_card_fixtures import (
    BIT_WIDTH, BLOCK_FRAMES, DENSE_COUNT_BAND, DEVICE, FRAMES_MAIN, M_MAIN,
    STREAM_FILES, check, pack, pdws_agree, pdws_identical, read_counts,
    reset_counts, write_segment)
from torch_card_fixtures import caps, card, pipe  # noqa: F401  (fixtures)

pytestmark = pytest.mark.card

STREAM_COUNTS = {
    "channelize_streams_packed_cm": "channelizer_kernel.launches_cm",
    "latch_cumsums": "latch_kernel.launches_tm",
    "pulse_stats_sat": "pulse_stats_kernel.launches",
    "pulse_stats_dense": "pulse_stats_kernel.launches_dense"}
STREAM_STEPS = ("fused_block", "floor_block", "nf_count_le", "nf_finish")
T0 = 1723800000.0


def staged_counts(ext, names=STREAM_STEPS) -> dict:
    """``{step: (hits, misses, graphs kept)}`` of an extractor's staged
    steps."""
    return {n: (s.hits, s.misses, len(s)) for n in names
            for s in [getattr(ext, f"_staged_{n}")]}


def in_turns(eager, staged, same) -> None:
    """``eager()`` and ``staged()`` in turns (eager, staged, staged, eager),
    each run's result handed to ``same(result, which)``."""
    for which in ("eager", "staged", "staged", "eager"):
        same((eager if which == "eager" else staged)(), which)


def extractor(pipe, cfg=None, **kw):
    from sdr_channelizer_tpu_torch.dsp.streaming import StreamingExtractor

    return StreamingExtractor(pipe.channelizer, cfg or pipe.pdw_cfg,
                              block_frames=BLOCK_FRAMES, device=DEVICE, **kw)


def test_four_files(pipe, caps, tmp_path):
    """The four files through the staged extractor with a checkpoint: each
    key captured once, every later block a replay; B6 on both passes of
    every block, B7 and the statistics on the detect pass; the floor from
    the device counts.  Held against single-shot extraction of the same
    samples (four times the slots), whose K2 floor it equals; resumed
    after losing the last two blocks; the plain run; the eager run in turns
    with the staged one, without a checkpoint, bit for bit, no key captured
    again.  Then the floor's count passes alone, staged and eager, and the
    oracle forms on one file."""
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp.streaming import CaptureSet
    from sdr_channelizer_tpu_torch.models import ChannelizerPipeline

    fs = M_MAIN * 1e6
    cfg = pipe.pdw_cfg
    n_blocks = STREAM_FILES * FRAMES_MAIN // BLOCK_FRAMES
    tmp = str(tmp_path)
    write_segment(tmp, [caps["sparse"]] * STREAM_FILES, fs, T0)
    cset = CaptureSet.from_dir(tmp)
    check(len(cset.segments) == 1
          and len(cset.segments[0].paths) == STREAM_FILES,
          "streaming: the four files are not one contiguous segment")
    seg = cset.segments[0]
    ext = extractor(pipe)
    ck = os.path.join(tmp, "ck")

    reset_counts(STREAM_COUNTS)
    got = ext.extract_segment_fused(seg, checkpoint_dir=ck)
    torch.cuda.synchronize()
    launches = read_counts(STREAM_COUNTS)
    # (f) every step staged: the keys are the first block (no history),
    # the middle ones and the last (no halo); the floor pass's first
    # and the rest; one a count pass.  Each key captured once, every
    # later block a replay
    keys = {"fused_block": 3, "floor_block": 2, "nf_count_le": 1,
            "nf_finish": 1}
    calls = {"fused_block": n_blocks, "floor_block": n_blocks,
             "nf_count_le": 8 * n_blocks, "nf_finish": n_blocks}
    cache = staged_counts(ext)
    check(cache == {n: (calls[n] - keys[n], keys[n], keys[n])
                    for n in keys},
          f"streaming: staged hits, misses, graphs {cache}")
    # (e) floor pass and detect pass of every block went through B6, the
    # detect pass through B7 and both statistics tiers; a capture adds
    # its eager warm-up to the replays
    check(launches["channelize_streams_packed_cm"]
          == 2 * n_blocks + keys["fused_block"] + keys["floor_block"]
          and launches["latch_cumsums"] == n_blocks + keys["fused_block"]
          and launches["pulse_stats_dense"] >= n_blocks,
          f"streaming: launch counts {launches} for {n_blocks} blocks")
    check(ext.counters.get("nf_device_count_d2h_bytes") > 0,
          "streaming: the noise floor did not take the device counts")
    check(len(got["toa"]) > 0, "streaming: no pulses")

    # (a) single-shot extraction of the same samples; its slot cap is
    # per capture, the streamed one per block, so it gets four times
    # the slots
    single = ChannelizerPipeline(
        pipe.channelizer, PdwConfig.channelized(
            max_pulses=STREAM_FILES * cfg.max_pulses,
            max_pulse_samples=cfg.max_pulse_samples), DEVICE)
    whole = np.concatenate([caps["sparse"]] * STREAM_FILES)
    nf1, _, batch = single.forward_packed(
        torch.as_tensor(pack(whole)), BIT_WIDTH)
    ref = single._finalize(batch, fs, 0.0, T0)
    del batch, whole
    check(int(ref["channel"].size) > 0 and np.bincount(
        ref["channel"]).max() < single.pdw_cfg.max_pulses,
        "streaming: the single-shot reference hit its slot cap")
    pdws_agree(got, ref, "streaming vs single-shot")
    check(np.array_equal(got["mag"], ref["mag"]),
          "streaming vs single-shot: mag differs")
    # (d) the streamed floor is the single-shot K2 floor
    nf_s = np.load(os.path.join(ck, "noise_floor.npz"))["nf"]
    check(np.array_equal(nf_s, nf1.cpu().numpy()),
          "streaming: noise floor differs from the single-shot one")
    del nf1, ref, single
    torch.cuda.empty_cache()

    # (c) resume after losing the last two blocks
    files = sorted(f for f in os.listdir(ck) if f.startswith("block_"))
    check(len(files) == n_blocks, f"streaming: {len(files)} checkpoints")
    for f in files[-2:]:
        os.remove(os.path.join(ck, f))
    ext2 = extractor(pipe)
    resumed = ext2.extract_segment_fused(seg, checkpoint_dir=ck)
    pdws_identical(resumed, got, "streaming, resumed")
    n_resumed = int(ext2.counters.get("blocks_resumed_from_checkpoint"))
    check(n_resumed == n_blocks - 2,
          f"streaming: {n_resumed} blocks resumed")

    # (b) the same run through the plain versions
    plain = extractor(pipe, plain=True).extract_segment_fused(seg)
    pdws_agree(got, plain, "streaming, kernels vs plain")
    for key in ("toa", "freq", "pw", "mag", "snr"):
        vals = got[key]
        ok = np.isfinite(vals) | (np.isnan(vals) if key == "freq" else False)
        check(bool(ok.all()), f"streaming: non-finite {key}")
    # (g) the staged run against the eager one, in turns, without a
    # checkpoint: bit for bit, and no key captured again
    eager = extractor(pipe)
    eager._eager = True
    in_turns(lambda: eager.extract_segment_fused(seg),
             lambda: ext.extract_segment_fused(seg),
             lambda res, which: pdws_identical(
                 res, got, f"streaming, {which} run vs the first"))
    check(all(s.misses == 0 and len(s) == 0 for s in
              (getattr(eager, f"_staged_{n}") for n in STREAM_STEPS)),
          "streaming: the eager run went through a staged step")
    after = staged_counts(ext)
    check(after == {n: (calls[n] * 3 - keys[n], keys[n], keys[n])
                    for n in keys},
          f"streaming: a staged key captured again: {after}")
    del plain, resumed, eager
    floor_pass_in_turns(ext, seg)
    oracle_in_turns(pipe, caps, fs, tmp_path)


def floor_pass_in_turns(ext, seg) -> None:
    """The streamed floor's count passes alone, over the block magnitudes
    of one more staged run of ``ext`` on ``seg``, resident on the card:
    staged (``ext``'s graphs, already captured) and eager in turns, the
    same floor, no key captured again."""
    mags = []
    measure = ext._noise_floor_device

    def keep(make_mag_blocks_dev, est_bytes=None):
        mags.extend(make_mag_blocks_dev())
        return measure(lambda: iter(mags), est_bytes)

    ext._noise_floor_device = keep
    try:
        ext.extract_segment_fused(seg)
    finally:
        del ext._noise_floor_device
    before = staged_counts(ext)
    floors = []

    def floor(eager: bool):
        ext._eager = eager
        return ext._noise_floor_device(lambda: iter(mags))

    in_turns(lambda: floor(True), lambda: floor(False),
             lambda nf, which: floors.append(nf))
    ext._eager = False
    check(all(np.array_equal(f, floors[0]) for f in floors),
          "streaming floor pass: staged and eager floors differ")
    after = staged_counts(ext)
    check(all(after[n][1:] == before[n][1:] for n in after),
          f"streaming floor pass: a key captured again: {after}")


def oracle_in_turns(pipe, caps, fs: float, tmp_path) -> None:
    """The oracle forms on one file of the sparse capture (4 blocks):
    ``extract_segment`` and ``extract`` through their staged block step and
    eagerly, in turns, bit for bit; two keys (a block with its halo, the
    last with the +inf pad), shared by both."""
    from sdr_channelizer_tpu_torch.dsp.streaming import CaptureSet

    tmp = str(tmp_path / "oracle")
    os.makedirs(tmp)
    write_segment(tmp, [caps["sparse"]], fs, T0)
    seg = CaptureSet.from_dir(tmp).segments[0]
    n_blocks = seg.num_samples // M_MAIN // BLOCK_FRAMES
    ext = extractor(pipe)
    ck = os.path.join(tmp, "ck")
    ref = ext.extract_segment(seg, checkpoint_dir=ck)
    nf = np.load(os.path.join(ck, "noise_floor.npz"))["nf"]
    eager = extractor(pipe)
    eager._eager = True

    def blocks():
        return seg.iter_samples(BLOCK_FRAMES * M_MAIN)

    runs = {
        "extract_segment": lambda e: e.extract_segment(seg, noise_floor=nf),
        "extract": lambda e: e.extract(blocks, fs, sample_start_time=T0,
                                       noise_floor=nf)}
    firsts = {}
    for name, run in runs.items():
        def same(res, which, name=name):
            firsts.setdefault(name, res)
            pdws_identical(res, firsts[name],
                           f"streaming oracle, {name} {which} run")

        in_turns(lambda: run(eager), lambda: run(ext), same)
    pdws_identical(firsts["extract_segment"], ref,
                   "streaming oracle: extract_segment with its floor")
    detect = ext._staged_detect_block
    check((detect.misses, len(detect)) == (2, 2)
          and detect.hits == 5 * n_blocks - 2
          and eager._staged_detect_block.misses == 0,
          f"streaming oracle: hits, misses {detect.hits}, {detect.misses}")


def test_dense_one_file(pipe, caps, tmp_path):
    """The dense capture as one file: every channel at its slot cap in
    every block, all pulses short, so max_pulse_samples = 128 holds them
    and the single-tier form (the slot grid with the mask) is what runs;
    staged and eager in turns bit for bit, the count within
    DENSE_COUNT_BAND of the plain run's."""
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp.streaming import CaptureSet

    fs = M_MAIN * 1e6
    dcfg = PdwConfig.channelized(max_pulses=pipe.pdw_cfg.max_pulses,
                                 max_pulse_samples=128)
    tmp = str(tmp_path)
    write_segment(tmp, [caps["dense"]], fs, T0)
    seg = CaptureSet.from_dir(tmp).segments[0]
    reset_counts(STREAM_COUNTS)
    dense_ext = extractor(pipe, dcfg)
    got = dense_ext.extract_segment_fused(seg)
    torch.cuda.synchronize()
    dense_launches = read_counts(STREAM_COUNTS)
    dense_eager = extractor(pipe, dcfg)
    dense_eager._eager = True
    in_turns(lambda: dense_eager.extract_segment_fused(seg),
             lambda: dense_ext.extract_segment_fused(seg),
             lambda res, which: pdws_identical(
                 res, got, f"streaming, dense {which} run"))
    del dense_ext, dense_eager
    plain = extractor(pipe, dcfg, plain=True).extract_segment_fused(seg)
    band = DENSE_COUNT_BAND * len(plain["toa"])
    check(abs(len(got["toa"]) - len(plain["toa"])) <= band,
          f"streaming, dense capture: {len(got['toa'])} pulses vs "
          f"{len(plain['toa'])} from the plain versions")
    check(dense_launches["pulse_stats_sat"] > 0,
          "streaming, dense capture: the slot-grid statistics never ran")
