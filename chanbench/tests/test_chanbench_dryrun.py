"""A tiny dry run of every cell through the harness on the CPU (the plain
versions): a result line to the contract, ``correct`` true, every metric of
the cell reported or marked missing."""

import pytest

from chanbench import harness
from chanbench.tests.helpers import bench, dry_run

CELLS = [w["name"] for w in bench()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run(cell):
    rc, line, err = dry_run(cell)
    assert rc == 0, err[-3000:]
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0, err[-2000:]
    assert line["attempted"] >= 1
    names = {m["name"] for m in harness.cell_metrics(bench(), cell,
                                                     "end_to_end")}
    assert set(line["metrics"]) == names
    assert line["device"]["platform"] == "cpu"
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


@pytest.mark.parametrize("cell", ["ch56_dense", "wb56_pulsetrain"])
def test_traced_dry_run(cell):
    rc, line, err = dry_run(cell, trace=1)
    assert rc == 0, err[-3000:]
    names = {m["name"] for m in harness.cell_metrics(bench(), cell,
                                                     "per_layer")}
    reported = set(line["metrics"])
    missing = {n for n in names if f"metric {n}: nothing to read" in err}
    assert reported | missing == names and not reported & missing
    assert "finalize_ms" in reported      # the wrapper's span
    if cell == "wb56_pulsetrain":
        assert "ingest_ms" in reported
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        harness.main(["--workload", "ch56_dense", "--seed", "1", "--seconds",
                      "1", "--trace", "0"])
    assert e.value.code == 2
    assert not capsys.readouterr().out.strip()
