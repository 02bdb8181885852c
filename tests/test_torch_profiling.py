"""The port's stage timer and profiler window on the CPU: stages accumulate
as the JAX package's do and report in its format, ``sync_device`` walks
the trees the pipelines return and waits on CUDA devices only, and
``trace`` writes a Chrome trace (or nothing without a directory).  The
program's spans: off, one shared no-op; on, kept with their parent, capture
and self time, closed when their body raises, and laid inside the caller's
profiler range; ``finalize_pdws`` and the streamed segment span their parts
and give the same PDWs either way; ``pdw --metrics`` prints them."""

import json
import os

import numpy as np
import pytest
import torch

from sdr_channelizer_tpu.utils.profiling import StageTimer as JStageTimer
from sdr_channelizer_tpu_torch.dsp.pdw import PdwBatch
from sdr_channelizer_tpu_torch.utils import StageTimer, profiling, trace

torch.set_num_threads(1)


def test_stages_accumulate_and_report_in_the_jax_format():
    timer = StageTimer()
    x = torch.randn(64, 64)
    for _ in range(3):
        with timer.stage("channelize", sync=x):
            x @ x
    with timer.stage("detect") as box:
        box.append({"y": x.sum()})
    with timer.stage("host"):
        pass
    assert timer.counts == {"channelize": 3, "detect": 1, "host": 1}
    assert all(t >= 0.0 for t in timer.totals.values())
    ref = JStageTimer(totals=dict(timer.totals), counts=dict(timer.counts))
    assert timer.report() == ref.report()
    assert timer.report().splitlines()[0].startswith(
        max(timer.totals, key=timer.totals.get))


def test_a_failing_stage_is_still_timed():
    timer = StageTimer()
    with pytest.raises(ZeroDivisionError):
        with timer.stage("bad"):
            1 / 0
    assert timer.counts == {"bad": 1}


def _batch():
    z = torch.zeros(2, 3)
    return PdwBatch(toa_idx=z.int(), te_idx=z.int(), pw_sec=z, mag=z,
                    snr_db=z, freq_offset_hz=z, saturated=z.bool(),
                    valid=z.bool(), count=torch.zeros(2, dtype=torch.int32))


def test_sync_device_walks_the_tree_and_waits_on_cuda_only(monkeypatch):
    tree = ({"nf": torch.ones(3), "batch": _batch()}, [torch.ones(1), 2.0],
            None, "label")
    found = list(profiling._tensors(tree))
    assert len(found) == 2 + 9
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    profiling.sync_device(tree)
    profiling.sync_device(None)
    assert calls == []  # CPU tensors and host values need no wait


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "prof"
    with trace(str(log_dir)):
        torch.randn(32, 32) @ torch.randn(32, 32)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(log_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)


def test_trace_without_a_directory_does_nothing(tmp_path):
    with trace(None):
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


# --------------------------------------------- the program's spans, counters

@pytest.fixture
def spans():
    """The recorder, cleared and on; off again after the test."""
    profiling.enable()
    yield profiling
    profiling.disable()


def test_spans_off_are_one_shared_no_op(monkeypatch):
    profiling.enable()
    profiling.disable()

    def no_range(name):
        raise AssertionError(f"a range was opened: {name}")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    first, second = profiling.span("a"), profiling.span("b")
    assert first is second
    with first:
        with second:
            profiling.count("n", 3)
    assert profiling.records() == []
    assert profiling.snapshot() == {"spans": {}, "counters": {}}
    assert not profiling.enabled()


def test_spans_on_carry_parent_capture_and_self_time(spans):
    with spans.span("entry.a"):
        with spans.span("b"):
            with spans.span("c"):
                pass
        with spans.span("b"):
            pass
    with spans.span("entry.d"):
        spans.count("bytes", 5)
        spans.count("bytes", 2)
    recs = spans.records()
    assert [(r.name, r.parent, r.capture) for r in recs] == [
        ("entry.a", -1, 0), ("b", 0, 0), ("c", 1, 0), ("b", 0, 0),
        ("entry.d", -1, 4)]
    assert all(r.end_ns is not None for r in recs)
    for r in recs[1:4]:
        parent = recs[r.parent]
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    ns = [r.end_ns - r.start_ns for r in recs]
    snap = spans.snapshot()
    assert snap["counters"] == {"bytes": 7}
    got = snap["spans"]
    assert {k: v["count"] for k, v in got.items()} == {
        "entry.a": 1, "b": 2, "c": 1, "entry.d": 1}
    assert got["entry.a"]["self_s"] == pytest.approx(
        (ns[0] - ns[1] - ns[3]) * 1e-9, abs=1e-12)
    assert got["b"]["self_s"] == pytest.approx(
        (ns[1] - ns[2] + ns[3]) * 1e-9, abs=1e-12)
    assert got["b"]["total_s"] == pytest.approx((ns[1] + ns[3]) * 1e-9,
                                                abs=1e-12)
    report = spans.report().splitlines()
    assert len(report) == 4 and all(" s  (" in line for line in report)


def test_spans_on_open_a_range_only_under_a_profiler(spans, monkeypatch):
    def no_range(name):
        raise AssertionError(f"a range was opened: {name}")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    with spans.span("entry.a"):
        pass
    assert [r.name for r in spans.records()] == ["entry.a"]


def test_a_raising_span_is_still_closed(spans):
    with pytest.raises(ZeroDivisionError):
        with spans.span("entry.bad"):
            with spans.span("inner"):
                1 / 0
    with spans.span("entry.next"):
        pass
    recs = spans.records()
    assert [(r.name, r.parent, r.capture) for r in recs] == [
        ("entry.bad", -1, 0), ("inner", 0, 0), ("entry.next", -1, 2)]
    assert all(r.end_ns is not None for r in recs)


def test_threads_keep_their_own_span_trees(spans):
    import sys
    import threading

    n_threads, n = 8, 200

    def work(k):
        for _ in range(n):
            with spans.span(f"entry.t{k}"):
                with spans.span(f"inner.t{k}"):
                    spans.count("calls")

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    recs = spans.records()
    assert len(recs) == 2 * n_threads * n
    for r in recs:
        if r.name.startswith("inner."):
            assert recs[r.parent].name == "entry." + r.name[len("inner."):]
            assert r.capture == r.parent
        else:
            assert r.parent == -1
    assert spans.snapshot()["counters"] == {"calls": n_threads * n}


def test_program_ranges_sit_inside_the_callers_range_on_one_clock():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    profiling.enable(prefix="caller.")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("caller.window"):
                with profiling.span("entry.step"):
                    with profiling.span("finalize.host"):
                        torch.ones(4).sum()
    finally:
        profiling.disable()
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU \
                and ev.name().startswith("caller."):
            ranges[ev.name()] = (ev.start_ns(),
                                 ev.start_ns() + ev.duration_ns())
    assert set(ranges) == {"caller.window", "caller.entry.step",
                           "caller.finalize.host"}

    def inside(inner, outer):
        return ranges[outer][0] <= ranges[inner][0] \
            <= ranges[inner][1] <= ranges[outer][1]

    assert inside("caller.entry.step", "caller.window")
    assert inside("caller.finalize.host", "caller.entry.step")


def _host_batch():
    g = np.random.default_rng(3)
    toa = np.sort(g.integers(0, 5000, (3, 4)), axis=1).astype(np.int32)
    valid = np.array([[1, 1, 0, 0], [1, 0, 0, 0], [1, 1, 1, 0]], bool)
    return PdwBatch(
        toa_idx=torch.from_numpy(toa), te_idx=torch.from_numpy(toa + 40),
        pw_sec=torch.full((3, 4), 40.0),
        mag=torch.from_numpy(g.random((3, 4), np.float32)),
        snr_db=torch.from_numpy(g.random((3, 4), np.float32) * 20),
        freq_offset_hz=torch.from_numpy(g.random((3, 4), np.float32) - 0.5),
        saturated=torch.from_numpy(g.random((3, 4)) > 0.5),
        valid=torch.from_numpy(valid),
        count=torch.tensor([2, 1, 3], dtype=torch.int32))


def test_finalize_spans_its_transfers_and_host_work():
    from sdr_channelizer_tpu_torch.dsp.pdw import finalize_pdws

    batch = _host_batch()
    kw = dict(fs=1e6, fc=5e8, sample_start_time=12.5,
              bin_offsets_hz=np.array([-1e6, 0.0, 1e6]))
    off = finalize_pdws(batch, **kw)
    profiling.enable()
    try:
        with profiling.span("entry.caller"):
            on = finalize_pdws(batch, **kw)
    finally:
        profiling.disable()
    recs = profiling.records()
    assert [(r.name, r.parent) for r in recs] == [
        ("entry.caller", -1), ("finalize.d2h", 0), ("finalize.host", 0)]
    assert list(on) == list(off) and len(on["toa"]) == 6
    for key in off:
        assert on[key].dtype == off[key].dtype
        np.testing.assert_array_equal(on[key], off[key], err_msg=key)


M, FS = 8, 8e6


@pytest.fixture(scope="module")
def segment_file(tmp_path_factory):
    from sdr_channelizer_tpu_torch.signal import (
        PulseTrainSpec,
        write_training_iq,
    )

    path = tmp_path_factory.mktemp("spans") / "d0.iq"
    spec = PulseTrainSpec(sample_rate_sps=FS, duration_sec=4096 * M / FS,
                          frequency_hz=1.02e6, pulse_width_sec=120e-6,
                          pri_sec=410e-6, start_index=37, noise_std=3e-3)
    write_training_iq(str(path), spec, bit_width=12, sample_start_time=50.0,
                      seed=4)
    return str(path)


def test_streamed_segment_spans_its_reads_floor_and_transfers(
        segment_file, monkeypatch):
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.dsp.streaming import (
        CaptureSet,
        Segment,
        StreamingExtractor,
    )

    seg = CaptureSet.from_paths([segment_file]).segments[0]
    ext = StreamingExtractor(
        Channelizer.create(M),
        PdwConfig.channelized(max_pulses=64, max_pulse_samples=256),
        block_frames=1024, halo_frames=256, device="cpu")
    off = ext.extract_segment_fused(seg, fc=5e8)

    inner = Segment.read_samples_raw
    open_at_read = []

    def read(self, start, count):
        open_at_read.append([r.name for r in profiling.records()
                             if r.end_ns is None])
        return inner(self, start, count)

    monkeypatch.setattr(Segment, "read_samples_raw", read)
    profiling.enable()
    try:
        on = ext.extract_segment_fused(seg, fc=5e8)
    finally:
        profiling.disable()
    n_blocks = 4
    # the host histogram's two passes (the floor on the CPU), detection
    assert len(open_at_read) == 3 * n_blocks
    assert all(names[-1] == "stream.read" for names in open_at_read)
    assert open_at_read[0] == ["entry.extract_segment_fused", "stream.floor",
                               "stream.read"]
    got = profiling.snapshot()["spans"]
    assert got["entry.extract_segment_fused"]["count"] == 1
    assert got["stream.floor"]["count"] == 1
    assert got["stream.to_host"]["count"] == n_blocks
    assert got["stream.read"]["count"] == 3 * n_blocks
    recs = profiling.records()
    assert {r.capture for r in recs} == {0}
    assert len(on["toa"]) > 4
    for key in off:
        np.testing.assert_array_equal(on[key], off[key], err_msg=key)


@pytest.mark.parametrize("stream", [False, True])
def test_pdw_metrics_prints_the_spans_beside_the_counters(
        segment_file, tmp_path, capsys, stream):
    from sdr_channelizer_tpu_torch.cli.main import main

    argv = ["pdw", segment_file, "--channelized", "--bands", str(M),
            "--max-pulses", "64", "--max-pulse-samples", "256",
            "--device", "cpu", "--metrics", "--out",
            str(tmp_path / "pdw.npz")]
    if stream:
        argv += ["--stream", "--block-frames", "1024"]
    assert main(argv) == 0
    line = next(json.loads(text) for text in
                capsys.readouterr().out.splitlines() if text.startswith("{"))
    assert set(line) == {"counters", "uptime_sec", "spans", "span_counters"}
    counted = {"files_processed"} | ({"blocks_processed", "samples_ingested",
                                      "pulses_emitted"} if stream else set())
    assert set(line["counters"]) == counted
    root = "entry.extract_segment_fused" if stream else "entry.extract_fused"
    assert {root, "finalize.d2h", "finalize.host"} <= set(line["spans"])
    assert set(line["spans"][root]) == {"count", "total_s", "self_s"}
    assert not profiling.enabled()
