"""``BENCHMARK.json`` keeps to the contract's shapes: names, units, keys,
and every file a cell is found by."""

import os
import re

from chanbench import compare, harness
from chanbench.tests.helpers import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert b["paths"] == ["chanbench"]
    assert all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert len(b["command"]) <= 32 and all(TEXT.match(w) for w in b["command"])
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_names_units_and_texts():
    b = bench()
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("chanbench/") and PATH.match(c["file"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("host_clock", "device_trace", "program_span",
                               "program_counter")
    for group in (b["configs"], b["workloads"],
                  b["end_to_end"] + b["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)


def test_every_cell_finds_its_files():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert len({(x["config"], x["traffic"]) for x in b["workloads"]}) == \
            len(b["workloads"])
        cfg = harness.load_json(harness.HERE, "configs", w["config"] + ".json")
        mix = harness.load_json(harness.HERE, "traffic", w["traffic"] + ".json")
        entry = mix.get("entry", cfg["entry"])
        assert os.path.exists(os.path.join(harness.HERE, "entries",
                                           entry + ".py"))
        limits = harness.load_json(harness.HERE, "limits", w["name"] + ".json")
        assert set(limits) == set(compare.NUMBERS)
        for section, folder in (("end_to_end", "e2e_metrics"),
                                ("per_layer", "layer_metrics")):
            mets = harness.cell_metrics(b, w["name"], section)
            assert mets
            for m in mets:
                assert os.path.exists(os.path.join(harness.HERE, folder,
                                                   m["name"] + ".py"))
        assert {"setup_s"} < {m["name"] for m in harness.cell_metrics(
            b, w["name"], "end_to_end")}


def test_per_layer_cells_report_what_they_move():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        mover = next(e for e in b["end_to_end"] if e["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(mover.get("workloads",
                                                               cells))
