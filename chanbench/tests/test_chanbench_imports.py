"""The import audit: no JAX module and nothing of the JAX package in a run
(top-level names compared whole), and nothing of the program in the
reference."""

import ast
import os
import subprocess
import sys
import types

from chanbench import harness
from chanbench.tests.helpers import PY, ROOT, dry_run, python_env


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(folder):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_whole_name_comparison(monkeypatch):
    assert harness.forbidden_modules() == []
    for name in ("jax", "jaxlib.xla_client", "flax", "sdr_channelizer_tpu",
                 "sdr_channelizer_tpu.io.iqpacket"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "sdr_channelizer_tpu_torchx",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == ["flax", "jax", "jaxlib",
                                           "sdr_channelizer_tpu"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(harness.HERE):
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (path, mod)


def test_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(harness.HERE, "reference")):
        for mod in _imports(path):
            assert mod.split(".")[0] in ("chanbench", "numpy", "torch",
                                         "__future__", "dataclasses",
                                         "typing"), (path, mod)
    code = ("import sys, chanbench.reference, chanbench.compare, "
            "chanbench.generator; print(sorted({m.split('.')[0] for m in "
            "sys.modules}))")
    out = subprocess.run([PY, "-c", code], cwd=ROOT, env=python_env(),
                         capture_output=True, text=True, check=True).stdout
    loaded = eval(out)
    assert "sdr_channelizer_tpu_torch" not in loaded
    assert not set(loaded) & set(harness.FORBIDDEN)


def test_a_run_loads_no_jax():
    code = ("import sys; from chanbench import harness; "
            "rc = harness.main(['--workload', 'ch56_dense', '--seed', '3', "
            "'--seconds', '0.2', '--trace', '0', '--device', 'cpu', '--set', "
            "'dwell_samples=114688', '--set', 'pool=1']); "
            "print('LOADED', sorted({m.split('.')[0] for m in sys.modules}))")
    proc = subprocess.run([PY, "-c", code], cwd=ROOT, env=python_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = eval(proc.stdout.split("LOADED", 1)[1])
    assert "sdr_channelizer_tpu_torch" in loaded
    assert not set(loaded) & set(harness.FORBIDDEN)


def test_a_jax_module_stops_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line, err = dry_run("ch56_dense")
    assert rc == 3 and line is None and "jax" in err
