"""The per-layer metric ``ingest_parallel_share``: the bytes that
``to_complex``'s thread pool wrote over all it wrote, from the program's
counters; nothing to read without the recorder or from a program that
keeps no ingest counter."""

from chanbench import harness
from chanbench.tests.helpers import bench

READER = harness.load_module("layer_metrics", "ingest_parallel_share")
RES = harness.Result(captures=4)


def _counted(monkeypatch, counters):
    from chanbench import program_spans

    snap = None if counters is None else {"spans": {}, "counters": counters}
    monkeypatch.setattr(program_spans, "recorded", lambda: snap)


def test_the_share_is_the_pool_bytes_over_the_ingest_bytes(monkeypatch):
    _counted(monkeypatch, {"ingest.to_complex_bytes": 400,
                           "ingest.to_complex_parallel_bytes": 300})
    assert READER.read(RES) == 75.0
    _counted(monkeypatch, {"ingest.to_complex_bytes": 400})
    assert READER.read(RES) == 0.0


def test_a_program_without_the_ingest_counter_gives_nothing(monkeypatch):
    _counted(monkeypatch, {"staged.copy_in_bytes": 400})
    assert READER.read(RES) is None
    _counted(monkeypatch, None)
    assert READER.read(RES) is None


def test_the_metric_is_read_in_the_wideband_cell_and_moves_msps():
    (m,) = [m for m in bench()["per_layer"]
            if m["name"] == "ingest_parallel_share"]
    assert m["moves"] == "msps" and m["unit"] == "%"
    assert m["layer"] == "host ingest (io.iqpacket.to_complex)"
    assert m["source"] == "program_counter" and m["better"] == "higher"
    assert m["workloads"] == ["wb56_pulsetrain"]
