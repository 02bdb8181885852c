"""On the card: each cell's control at the cell's own size fails the check
on three seeds, and a short run of the cell passes it.  Skipped without a
card; run on the card with ``python -m pytest chanbench/tests -o
addopts="" -m card``."""

import json
import subprocess

import pytest

from chanbench.tests.helpers import PY, ROOT, bench, python_env

CELLS = [w["name"] for w in bench()["workloads"]]


def _run(cell, seed, *extra):
    proc = subprocess.run(
        [PY, "chanbench/run.py", "--workload", cell, "--seed", str(seed),
         "--seconds", "2", "--trace", "0", *extra], cwd=ROOT,
        env=python_env(), capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [9001, 9002, 9003])
def test_control_fails_on_the_card(card, cell, seed):
    assert _run(cell, seed, "--control")["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_passes_on_the_card(card, cell):
    assert _run(cell, 9100)["correct"] is True
