"""A configuration, a traffic mix, a cell's limits and a metric added as
new files are found by name: the harness needs no edit."""

import json
import os
import re
import shutil
import subprocess

import torch

from chanbench import harness
from chanbench.tests.helpers import PY, ROOT, bench, python_env


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(os.path.join(ROOT, "chanbench"), root / "chanbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cb = root / "chanbench"
    cfg = json.loads((cb / "configs" / "ch56_bladerf12.json").read_text())
    cfg.update(name="ch8_test", num_bands=8, dwell_samples=8 * 4096)
    (cb / "configs" / "ch8_test.json").write_text(json.dumps(cfg))
    (cb / "traffic" / "one_tone.json").write_text(json.dumps({
        "pool": 1, "noise_std": 0.001, "emitters": [
            {"count": 1, "freq_hz": 1e6, "pw_s": 2e-5, "pri_s": 1e-4,
             "amplitude": 0.5}]}))
    (cb / "limits" / "ch8_test.one_tone.json").write_text(json.dumps({
        "unpaired_pct": 0.0, "mag_gap": 1e-3, "snr_gap_db": 1e-2,
        "freq_gap_hz": 100.0}))
    (cb / "e2e_metrics" / "captures_n.py").write_text(
        "def read(res):\n    return float(res.captures)\n")
    b = bench()
    b["configs"].append({"name": "ch8_test", "source": "a test",
                         "file": "chanbench/configs/ch8_test.json",
                         "reduced": [], "why": "a test"})
    b["workloads"] = [{"name": "ch8_test.one_tone", "config": "ch8_test",
                       "traffic": "one_tone", "chips": 1, "why": "a test"}]
    b["end_to_end"].append({"name": "captures_n", "unit": "1",
                            "better": "higher", "bound": 0.01,
                            "source": "host_clock"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    proc = subprocess.run(
        [PY, "chanbench/run.py", "--workload", "ch8_test.one_tone", "--seed",
         "4", "--seconds", "0.2", "--trace", "0", "--device", "cpu"],
        cwd=root, env=python_env(), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["captures_n"]["value"] >= 1
    # an end-to-end metric with a list of cells is reported in those alone
    listed = {m["name"] for m in b["end_to_end"]
              if "ch8_test.one_tone" in m.get("workloads",
                                              ["ch8_test.one_tone"])}
    assert listed >= {"msps", "setup_s", "captures_n"}
    assert set(line["metrics"]) == listed


def test_an_int8_config_and_a_law_are_found_by_name(tmp_path):
    """An 8-bit deployment and a mix whose dwells another generator makes,
    ``laws/<law>.py``, each added as a file of its own."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(os.path.join(ROOT, "chanbench"), root / "chanbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cb = root / "chanbench"
    cfg = json.loads((cb / "configs" / "ch56_bladerf12.json").read_text())
    cfg.update(name="ch8_int8", num_bands=8, dwell_samples=8 * 4096,
               bit_width=8, payload_dtype="int8")
    (cb / "configs" / "ch8_int8.json").write_text(json.dumps(cfg))
    (cb / "laws").mkdir(exist_ok=True)
    (cb / "laws" / "checked_tones.py").write_text(
        "import sys\n"
        "from chanbench import generator\n\n\n"
        "def make_pool(mix, cfg, seed, device, out_dir=None):\n"
        "    items = generator.make_pool(mix, cfg, seed, device, out_dir)\n"
        "    kinds = {p.dtype.name for it in items for p in it.payloads}\n"
        "    print('law checked_tones:', *sorted(kinds), file=sys.stderr)\n"
        "    return items\n")
    (cb / "traffic" / "law_tone.json").write_text(json.dumps({
        "law": "checked_tones", "pool": 2, "noise_std": 0.004,
        "emitters": [{"count": 1, "freq_hz": 1e6, "pw_s": 2e-5,
                      "pri_s": 1e-4, "amplitude": 0.5}]}))
    (cb / "limits" / "ch8_int8.law_tone.json").write_text(json.dumps({
        "unpaired_pct": 0.0, "mag_gap": 1e-3, "snr_gap_db": 1e-2,
        "freq_gap_hz": 100.0}))
    b = bench()
    b["configs"].append({"name": "ch8_int8", "source": "a test",
                         "file": "chanbench/configs/ch8_int8.json",
                         "reduced": [], "why": "a test"})
    b["workloads"] = [{"name": "ch8_int8.law_tone", "config": "ch8_int8",
                       "traffic": "law_tone", "chips": 1, "why": "a test"}]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    proc = subprocess.run(
        [PY, "chanbench/run.py", "--workload", "ch8_int8.law_tone", "--seed",
         str(2 ** 31 + 11), "--seconds", "0.2", "--trace", "0", "--device",
         "cpu"], cwd=root, env=python_env(), capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "law checked_tones: int8" in proc.stderr
    counts = re.search(r"PDWs an item, program/reference: (.*)",
                       proc.stderr).group(1).split()
    assert counts and all(c.split("/")[0] == c.split("/")[1] != "0"
                          for c in counts), counts
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] >= 1


def test_only_the_benchmark_files_is_no_run(tmp_path):
    """A checkout with ``BENCHMARK.json`` and ``chanbench/`` alone (no
    program) exits with an error and prints no result."""
    shutil.copytree(os.path.join(ROOT, "chanbench"), tmp_path / "chanbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [PY, "chanbench/run.py", "--workload", "ch56_dense", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_staged_steps_are_found_by_their_counts_not_their_names():
    from sdr_channelizer_tpu_torch.models import ChannelizerPipeline

    pipe = ChannelizerPipeline.create(8, device=torch.device("cpu"))
    steps = harness.staged_steps(pipe)
    assert steps and all(isinstance(s.hits, int) and isinstance(s.misses, int)
                         for s in steps)

    class Renamed:
        pass

    owner = Renamed()
    owner.step_a, owner.table, owner.flag = steps[0], {"k": steps[1]}, True
    owner.flags = type("Flags", (), {"hits": True, "misses": False})()
    assert harness.staged_steps(owner) == [steps[0], steps[1]]
