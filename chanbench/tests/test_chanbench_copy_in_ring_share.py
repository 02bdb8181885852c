"""The per-layer metric ``copy_in_ring_share``: the page-locked bytes
over the host bytes of the staged copy-ins, from the program's counters;
nothing to read without the recorder, without a copy-in, or from a
program that keeps no page-locked counter."""

from chanbench import harness
from chanbench.tests.helpers import bench

READER = harness.load_module("layer_metrics", "copy_in_ring_share")
RES = harness.Result(captures=4)


def _counted(monkeypatch, counters):
    from chanbench import program_spans

    monkeypatch.setattr(program_spans, "recorded",
                        lambda: {"spans": {}, "counters": counters})


def test_the_share_is_the_ring_bytes_over_the_host_bytes(monkeypatch):
    _counted(monkeypatch, {"staged.copy_in_bytes": 400,
                           "staged.copy_in_ring_bytes": 300})
    assert READER.read(RES) == 75.0
    _counted(monkeypatch, {"staged.copy_in_bytes": 400,
                           "staged.copy_in_ring_bytes": 0})
    assert READER.read(RES) == 0.0
    _counted(monkeypatch, {})
    assert READER.read(RES) is None


def test_a_program_without_the_ring_gives_nothing(monkeypatch):
    _counted(monkeypatch, {"staged.copy_in_bytes": 400})
    assert READER.read(RES) is None


def test_the_metric_is_read_in_every_cell_and_moves_msps():
    (m,) = [m for m in bench()["per_layer"]
            if m["name"] == "copy_in_ring_share"]
    assert m["moves"] == "msps" and m["unit"] == "%"
    assert m["workloads"] == [w["name"] for w in bench()["workloads"]]
