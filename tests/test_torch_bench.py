"""The port's benchmark harness on the CPU: ``sdr_channelizer_tpu_torch.bench``
against the root ``bench.py`` (its captures) and the JAX package's cm2 route
(its pulse counts), its JSON line, its refusal to run without a card, and
``bench_scaling`` on a host mesh of four shards.  The timings themselves
are host-clock readings of the plain versions and are checked only for
being finite and positive."""

import contextlib
import importlib
import importlib.util
import io
import json
import math
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.config import PdwConfig as JPdwConfig
from sdr_channelizer_tpu.models.pipeline import (
    ChannelizerPipeline as JPipeline,
)
from sdr_channelizer_tpu.ops import medians as jmedians
from sdr_channelizer_tpu_torch import bench, bench_scaling

# the CLI modules (each package's ``cli`` exports the function ``main``)
jcli = importlib.import_module("sdr_channelizer_tpu.cli.main")
tcli = importlib.import_module("sdr_channelizer_tpu_torch.cli.main")

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 8
FRAMES = 4096
SMALL = ["--cpu", "--bands", str(M), "--frames", str(FRAMES)]
# bench.py:357-372
ROOT_KEYS = {"metric", "value", "unit", "vs_baseline", "latency_p50_ms",
             "dense_pulses_per_step", "sparse_msps", "sparse_pulses_per_step",
             "protocol", "rep_spread_pct", "ingest", "device"}
# bench_scaling.py:120-139
SIZE_KEYS = {"metric", "devices", "mesh", "value", "unit"}
SUMMARY_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _load(name):
    """A root script of the repo, loaded by path (it imports only NumPy at
    module level)."""
    spec = importlib.util.spec_from_file_location(
        f"_root_{name}", os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, argv):
    """``fn(argv)``'s return code, standard output and standard error."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.strip()]


@pytest.fixture(scope="module")
def jax_counts():
    """``batch.count.sum()`` of one JAX cm2 step (Pallas kernels in
    interpret mode) on each capture, at the bench's configuration."""
    jpipe = JPipeline.create(M, pdw_cfg=JPdwConfig.channelized(
        max_pulses=512, max_pulse_samples=1024))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmedians, "use_sort_free", lambda: True)
        for key in ("dense", "sparse"):
            i16 = bench.quantize(bench.make_capture(M * FRAMES, M,
                                                    sparse=key == "sparse"))
            xq = np.ascontiguousarray(i16).view(np.int32).ravel()
            _, _, batch = jpipe.forward_packed(jnp.asarray(xq), bit_width=12,
                                               route="cm2")
            out[key] = int(np.asarray(batch.count).sum())
    return out


@pytest.fixture(scope="module")
def headline():
    rc, out, err = _run(bench.main, SMALL + ["--iters", "1", "--rounds", "2"])
    assert rc == 0
    return _json_lines(out), err


@pytest.mark.parametrize("bands", [8, 64])
@pytest.mark.parametrize("sparse", [False, True])
def test_captures_are_the_root_benchs_bit_for_bit(bands, sparse):
    root = _load("bench")
    n = bands * 2048
    cap = bench.make_capture(n, bands, sparse=sparse)
    ref = root._make_capture(n, bands, sparse=sparse)
    assert cap.dtype == ref.dtype == np.complex64
    np.testing.assert_array_equal(cap.view(np.uint32), ref.view(np.uint32))
    q, qref = bench.quantize(cap), root._quantize(ref)
    assert q.dtype == qref.dtype == np.int16 and q.shape == (n, 2)
    np.testing.assert_array_equal(q, qref)


def test_line_has_the_root_keys_and_the_ports(headline):
    lines, err = headline
    assert len(lines) == 1
    line = lines[0]
    assert set(line) == ROOT_KEYS | {"device_step_ms", "power_limit_w"}
    assert line["metric"] == "channelize_pdw_throughput"
    assert line["unit"] == "Msamples/s/card"
    assert line["ingest"] == "packed_int16"
    assert line["device"] == "cpu"
    # no graph and no power limit without a card
    assert line["device_step_ms"] is None and line["power_limit_w"] is None
    assert "K=1" in line["protocol"] and "R=2" in line["protocol"]
    for key in ("value", "latency_p50_ms", "sparse_msps"):
        assert math.isfinite(line[key]) and line[key] > 0, key
    assert line["vs_baseline"] == pytest.approx(line["value"] / 56.0)
    assert line["value"] == pytest.approx(
        M * FRAMES / line["latency_p50_ms"] / 1e3)
    assert 0 <= line["rep_spread_pct"] < math.inf
    assert "bench: device = cpu" in err
    assert "bench: host launches a dense step in" in err


def test_sparse_pulses_are_the_jax_cm2_routes(headline, jax_counts):
    assert headline[0][0]["sparse_pulses_per_step"] == jax_counts["sparse"] > 0


def test_dense_pulses_within_the_smokes_band(headline, jax_counts):
    """The dense capture's 1-2 sample pulses hover at the threshold, where
    the two packages' float sums in another order may tip a sample: the
    count is held to chip_smoke.py's band, 2 %."""
    band = _load("chip_smoke").DENSE_COUNT_BAND
    got = headline[0][0]["dense_pulses_per_step"]
    assert abs(got - jax_counts["dense"]) <= band * jax_counts["dense"]
    assert got > jax_counts["sparse"]


@pytest.mark.parametrize("flag", ["--stages", "--planes"])
def test_stages_and_planes_print_their_lines(headline, flag):
    rc, out, err = _run(bench.main, SMALL + ["--iters", "1", "--rounds", "1",
                                             flag])
    assert rc == 0
    (line,) = _json_lines(out)
    assert set(line) == ROOT_KEYS | {"device_step_ms", "power_limit_w"}
    packed = headline[0][0]
    # the planes hold the payload's values exactly: the same pulses
    assert line["dense_pulses_per_step"] == packed["dense_pulses_per_step"]
    assert line["sparse_pulses_per_step"] == packed["sparse_pulses_per_step"]
    if flag == "--planes":
        assert line["ingest"] == "f32_planes"
        return
    assert line["ingest"] == "packed_int16"
    stages = re.findall(r"^bench: (\S+)\s+([0-9.]+) Msps  \(([0-9.]+) ms\)$",
                        err, re.M)
    assert [s[0] for s in stages] == ["streams_kernel", "noise_floor",
                                      "pdw_extract"]
    assert all(float(s[1]) > 0 for s in stages)


def test_without_a_card_it_raises_and_falls_back_to_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.main(["--bands", str(M), "--frames", str(FRAMES)])
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench_scaling.main(["--bands", str(M)])


@pytest.mark.parametrize("extra", [[], ["--fused"], ["--fixed-total"],
                                   ["--fused", "--fixed-total"]])
def test_scaling_on_a_host_mesh_of_four(extra):
    rc, out, _ = _run(bench_scaling.main, [
        "--cpu-devices", "4", "--bands", str(M), "--frames-per-device",
        "2048", "--iters", "1", *extra])
    assert rc == 0
    lines = _json_lines(out)
    assert len(lines) == 4
    eff = "overhead_efficiency" if "--fixed-total" in extra \
        else "scaling_efficiency"
    for line, nd in zip(lines, (1, 2, 4)):
        assert set(line) == SIZE_KEYS | {eff}
        assert line["metric"] == "sharded_throughput"
        assert line["devices"] == nd and line["mesh"] == f"{nd}x1"
        assert line["unit"] == "Msamples/s" and line["value"] > 0
    assert lines[0][eff] == 1.0
    summary = lines[-1]
    assert set(summary) == SUMMARY_KEYS
    assert summary["metric"] == ("sharding_overhead_efficiency"
                                 if "--fixed-total" in extra
                                 else "scaling_efficiency")
    assert summary["unit"] == "1->4 devices"


def test_scaling_chan_split_meshes():
    rc, out, _ = _run(bench_scaling.main, [
        "--cpu-devices", "4", "--bands", str(M), "--frames-per-device",
        "2048", "--iters", "1", "--chan-split", "2"])
    assert rc == 0
    assert [line.get("mesh") for line in _json_lines(out)] == [
        "1x1", "1x2", "2x2", None]


def test_scaling_refuses_fused_with_a_chan_split():
    with pytest.raises(SystemExit) as e:
        _run(bench_scaling.main, ["--cpu-devices", "2", "--fused",
                                  "--chan-split", "2"])
    assert e.value.code == 2


@pytest.mark.parametrize("cli", [jcli, tcli], ids=["jax", "port"])
def test_cli_reads_bench_flags_after_dashdash(monkeypatch, cli):
    """Both CLIs hand what follows ``--`` to the harness; before it, a
    harness flag is an unknown option of the top parser."""
    seen = []
    monkeypatch.setattr(cli, "cmd_bench",
                        lambda args: seen.append(args.bench_args) or 0)
    assert cli.main(["bench", "--", "--stages", "--iters", "3"]) == 0
    assert cli.main(["bench"]) == 0
    assert seen == [["--stages", "--iters", "3"], []]
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--stages"])
    assert e.value.code == 2


def test_port_sources_import_no_root_script():
    pat = re.compile(r"^\s*(import|from)\s+(bench|bench_scaling|chip_smoke)"
                     r"(\.|\s|$)", re.M)
    port = os.path.join(REPO, "sdr_channelizer_tpu_torch")
    sources = [os.path.join(root, f) for root, _, files in os.walk(port)
               for f in files if f.endswith(".py")]
    assert any(s.endswith("bench_scaling.py") for s in sources)
    for path in sources:
        with open(path) as f:
            assert not pat.search(f.read()), path
