"""The per-layer metrics read from the program's own spans and counters
(``chanbench/program_spans.py``): a traced dry run of the streamed cell
reports the streamed path's and finalize's metrics and names its idle
gaps by program spans; a program without the recorder gives nothing to
read and the run goes on; on the card, the staged step's hit path records
one copy-in, replay and clone a call, the copy-in's bytes the payload's."""

import numpy as np
import pytest

from chanbench import harness, program_spans
from chanbench.tests.helpers import bench, dry_run

PROGRAM = ("entry.", "staged.", "finalize.", "stream.")


def test_traced_stream_dry_run_reports_the_program_spans():
    rc, line, err = dry_run("ch56_stream", trace=1)
    assert rc == 0, err[-3000:]
    assert line["correct"] is True
    names = {m["name"] for m in harness.cell_metrics(bench(), "ch56_stream",
                                                     "per_layer")}
    wanted = {"stream_read_ms", "stream_floor_ms", "stream_to_host_ms",
              "finalize_host_ms"}
    assert wanted <= names
    for name in wanted:
        assert line["metrics"][name]["value"] > 0, name
    assert all(gap.startswith(PROGRAM)
               for gap, _ in line["breakdown"]["idle_gaps"])


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    from sdr_channelizer_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "enable")
    program_spans.install(None)
    assert program_spans.recorded() is None
    res = harness.Result(captures=3)
    for name in ("copy_in_gbps", "launch_ms", "finalize_wait_ms",
                 "finalize_d2h_ms", "finalize_host_ms", "stream_read_ms",
                 "stream_floor_ms", "stream_to_host_ms"):
        assert harness.load_module("layer_metrics", name).read(res) is None


@pytest.mark.card
def test_staged_hit_path_records_its_copy_in_replay_and_clone(card):
    import torch

    from sdr_channelizer_tpu_torch._staging import Staged
    from sdr_channelizer_tpu_torch.utils import profiling

    step = Staged(lambda x: x * 2 + 1, card)
    x = np.arange(1 << 16, dtype=np.float32)
    step(x)                                  # the capture
    profiling.enable()
    try:
        outs = [step(x) for _ in range(3)]
    finally:
        profiling.disable()
    snap = profiling.snapshot()
    assert {k: v["count"] for k, v in snap["spans"].items()} == {
        "staged.copy_in": 3, "staged.replay": 3, "staged.clone": 3}
    assert snap["counters"] == {"staged.copy_in_bytes": 3 * x.nbytes}
    assert (step.hits, step.misses) == (3, 1)
    for out in outs:
        torch.testing.assert_close(out.cpu(), torch.from_numpy(x * 2 + 1),
                                   rtol=0, atol=0)


@pytest.mark.card
def test_pdws_are_the_same_with_spans_on_and_off_on_the_card(card):
    from sdr_channelizer_tpu_torch.models import (
        ChannelizerPipeline,
        WidebandPdwPipeline,
    )
    from sdr_channelizer_tpu_torch.utils import profiling

    g = np.random.default_rng(11)
    m, frames = 56, 16384
    t = np.arange(m * frames)
    iq = 1e-3 * (g.standard_normal(t.size) + 1j * g.standard_normal(t.size))
    iq += 0.5 * np.exp(2j * np.pi * 0.13 * t) * ((t // 7000) % 3 == 0)
    raw = np.round(np.stack([iq.real, iq.imag], -1) * 2047).astype(np.int16)
    chan = ChannelizerPipeline.create(m, device=card)
    wide = WidebandPdwPipeline(device=card)
    calls = [lambda: chan.extract_fused(raw, bit_width=12, fs=56e6),
             lambda: wide.extract(iq.astype(np.complex64), fs=56e6)]
    for call in calls:
        call()                               # the capture
        off = call()
        profiling.enable()
        try:
            on = call()
        finally:
            profiling.disable()
        assert len(off["toa"]) > 0
        for key in off:
            assert on[key].dtype == off[key].dtype
            np.testing.assert_array_equal(on[key], off[key], err_msg=key)
    assert {"finalize.wait", "finalize.d2h", "staged.replay"} <= set(
        profiling.snapshot()["spans"])
