"""The port's stage timer and profiler window on the CPU: stages accumulate
as the JAX package's do and report in its format, ``sync_device`` walks
the trees the pipelines return and waits on CUDA devices only, and
``trace`` writes a Chrome trace (or nothing without a directory)."""

import json
import os

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
