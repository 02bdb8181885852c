"""The port's new CLI commands on ``--device cpu`` against the JAX CLI's
outputs, on every capture container: ``convert``, ``channelize`` (``chan_iq``
within rtol = atol = 1e-5, the waterfall PNG, frames and video),
``spectrogram``, ``plot``, ``pdw`` on raw and float containers (and
``--png``), ``predict`` on converted dwells with ``--png``, and ``txrx``."""

import os

import numpy as np
import pytest
import torch

from sdr_channelizer_tpu.cli.main import main as jmain
from sdr_channelizer_tpu.dsp import spectrogram as jsg
from sdr_channelizer_tpu.io import convert as jconv
from sdr_channelizer_tpu_torch.cli.main import main
from sdr_channelizer_tpu_torch.dsp import spectrogram as tsg
from sdr_channelizer_tpu_torch.io import iqpacket as tiq
from sdr_channelizer_tpu_torch.signal.synth import PulseTrainSpec, pulse_train
from torch_port_fixtures import png_size, same_load

torch.set_num_threads(1)

FS = 8e6
T0 = 1723800000.0
CHAN_TOL = 1e-5      # tests/test_pallas_kernel.py:24
SPEC_RTOL = 1e-5     # tests/test_spectrogram.py:94
MESH_TOL = 1e-5      # of the largest power: test_torch_spectrogram.py
RAW = ("iq", "npz_raw", "mat_raw", "mat73_raw")
FLOAT = ("npz", "mat", "mat73")
CONTAINERS = RAW + FLOAT + ("bin",)


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """2 ms at 8 Msps (a 2 MHz tone, 100 us pulses every 500 us, one of them
    clipped, in noise) as a v3 ``.iq`` at bit width 12, converted by the
    port's CLI to every other container, and a legacy ``.bin`` of the same
    samples."""
    d = tmp_path_factory.mktemp("caps")
    spec = PulseTrainSpec(sample_rate_sps=FS, duration_sec=2e-3,
                          frequency_hz=2.0e6, pulse_width_sec=100e-6,
                          pri_sec=500e-6, start_index=1234, noise_std=3e-3)
    iq = pulse_train(spec, seed=2)
    iq[5000:5100] = 1.0 + 1.0j
    samples = tiq.from_complex(iq, 12)
    src = str(d / "cap.iq")
    tiq.write_iq(src, tiq.IqHeader(
        frequency_hz=2.4e9, bandwidth_hz=FS, sample_rate_sps=FS,
        rx_gain_db=30.0, num_samples=len(iq), bit_width=12,
        sample_start_time=T0, board_name="b", serial_number="s"), samples)
    paths = {"iq": src}
    for kind, flags in (("npz_raw", ["--raw"]), ("npz", []),
                        ("mat_raw", ["--mat", "--raw"]), ("mat", ["--mat"]),
                        ("mat73_raw", ["--mat", "--v73", "--raw"]),
                        ("mat73", ["--mat", "--v73"])):
        out = d / kind
        assert main(["convert", src, "--out-dir", str(out)] + flags) == 0
        paths[kind] = str(out / ("cap.mat" if "mat" in kind else "cap.npz"))
    deq = tiq.to_complex(samples, 12)
    paths["bin"] = str(d / "8M_2400_MHz_0.bin")
    np.stack([deq.real, deq.imag], -1).astype("<f4").tofile(paths["bin"])
    return paths


def _run(fn, argv, capsys):
    assert fn(argv) == 0
    return capsys.readouterr().out.split()


@pytest.mark.parametrize("flags", [[], ["--raw"], ["--mat"], ["--mat", "--raw"],
                                   ["--mat", "--v73"],
                                   ["--mat", "--v73", "--raw"], "bin"])
def test_cli_convert_writes_the_jax_containers(tmp_path, captures, capsys,
                                               flags):
    src = captures["bin"] if flags == "bin" else captures["iq"]
    flags = [] if flags == "bin" else flags
    got = _run(main, ["convert", src, "--out-dir", str(tmp_path / "t")]
               + flags, capsys)
    ref = _run(jmain, ["convert", src, "--out-dir", str(tmp_path / "j")]
               + flags, capsys)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in ref]
    same_load(jconv.load_capture(got[0]), jconv.load_capture(ref[0]))
    same_load(jconv.load_capture_raw(got[0]),
               jconv.load_capture_raw(ref[0]))
    if got[0].endswith(".npz"):
        t, j = np.load(got[0]), np.load(ref[0])
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            assert t[k].dtype == j[k].dtype
            np.testing.assert_array_equal(t[k], j[k])
    if "--v73" in flags:
        with open(got[0], "rb") as f, open(ref[0], "rb") as g:
            assert f.read(512) == g.read(512)


@pytest.mark.parametrize("kind", ["iq", "npz_raw", "mat", "mat73_raw", "bin"])
def test_cli_channelize_matches_jax(tmp_path, captures, capsys, kind):
    path = captures[kind]
    got = _run(main, ["channelize", path, "--bands", "8", "--out-dir",
                      str(tmp_path / "t"), "--device", "cpu"], capsys)
    ref = _run(jmain, ["channelize", path, "--bands", "8", "--out-dir",
                       str(tmp_path / "j")], capsys)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in ref] == ["cap_chan.npz"
                                                if kind != "bin" else
                                                "8M_2400_MHz_0_chan.npz"]
    t, j = np.load(got[0]), np.load(ref[0])
    assert sorted(t.files) == sorted(j.files)
    assert t["chan_iq"].shape == j["chan_iq"].shape == (2000, 8)
    np.testing.assert_allclose(t["chan_iq"], j["chan_iq"], rtol=CHAN_TOL,
                               atol=CHAN_TOL)
    for k in ("fs", "center_frequencies", "sample_start_time"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_cli_channelize_views_are_the_jax_views(tmp_path, captures, capsys):
    views = ["--bands", "8", "--png", "--frames-dir", None,
             "--frame-window-sec", "0.5e-3", "--frame-limit", "2", "--video"]
    out = {}
    for name, fn, extra in (("t", main, ["--device", "cpu"]),
                            ("j", jmain, [])):
        argv = [a if a is not None else str(tmp_path / name / "frames")
                for a in views]
        out[name] = _run(fn, ["channelize", captures["iq"], "--out-dir",
                              str(tmp_path / name)] + argv + extra, capsys)
    names = [os.path.relpath(p, tmp_path / "t") for p in out["t"]]
    assert names == [os.path.relpath(p, tmp_path / "j") for p in out["j"]]
    assert names == ["cap_chan.npz", "cap_waterfall.png",
                     os.path.join("frames", "frame_00000.png"),
                     os.path.join("frames", "frame_00001.png"),
                     "cap_waterfall.mp4"]
    for p, q in zip(out["t"][1:4], out["j"][1:4]):
        assert png_size(p) == png_size(q)
    assert os.path.getsize(out["t"][4]) > 0


def _captured_power(monkeypatch, mod):
    seen = []
    monkeypatch.setattr(mod, "save_png",
                        lambda path, power, *a, **k: seen.append(
                            (path, np.asarray(power), a, k)))
    return seen


@pytest.mark.parametrize("kind", ["iq", "npz_raw", "mat73_raw", "npz", "mat",
                                  "bin"])
def test_cli_spectrogram_matches_jax(tmp_path, captures, capsys, monkeypatch,
                                     kind):
    got = _captured_power(monkeypatch, tsg)
    ref = _captured_power(monkeypatch, jsg)
    path = captures[kind]
    printed = _run(main, ["spectrogram", path, "--out-dir",
                          str(tmp_path / "t"), "--device", "cpu"], capsys)
    jprinted = _run(jmain, ["spectrogram", path, "--out-dir",
                            str(tmp_path / "j")], capsys)
    assert [os.path.basename(p) for p in printed] == \
        [os.path.basename(p) for p in jprinted]
    (p, power, a, k), (q, jpower, b, l) = got[0], ref[0]
    assert os.path.basename(p) == os.path.basename(q)
    assert a == b and k.keys() == l.keys() and k["title"] == l["title"]
    assert power.shape == jpower.shape == (20, 768)
    np.testing.assert_allclose(power, jpower, rtol=SPEC_RTOL,
                               atol=MESH_TOL * jpower.max())


def test_cli_spectrogram_png_is_the_jax_png_size(tmp_path, captures, capsys):
    got = _run(main, ["spectrogram", captures["npz_raw"], "--out-dir",
                      str(tmp_path / "t"), "--device", "cpu", "--window",
                      "256"], capsys)
    ref = _run(jmain, ["spectrogram", captures["npz_raw"], "--out-dir",
                       str(tmp_path / "j"), "--window", "256"], capsys)
    assert png_size(got[0]) == png_size(ref[0])


@pytest.mark.parametrize("kind", ["iq", "npz", "mat73_raw", "bin"])
def test_cli_plot_matches_jax(tmp_path, captures, capsys, kind):
    got = _run(main, ["plot", captures[kind], "--out-dir",
                      str(tmp_path / "t")], capsys)
    ref = _run(jmain, ["plot", captures[kind], "--out-dir",
                       str(tmp_path / "j")], capsys)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in ref]
    assert png_size(got[0]) == png_size(ref[0])


def _assert_pdws_close(got, ref, channelized):
    """The bars of the existing tests between the two packages: channelized
    ``tests/test_torch_pipeline.py::_assert_pdws_close`` (the JAX CLI runs
    its FFT oracle on the CPU), wideband ``tests/test_torch_wideband.py::
    test_pipeline_forward_and_extract_match_jax``."""
    assert len(got["toa"]) == len(ref["toa"]) > 0
    for key in ("channel", "sat") + (() if channelized else ("toa", "pw")):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    if channelized:
        np.testing.assert_allclose(got["toa"], ref["toa"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(got["pw"], ref["pw"], rtol=1e-6, atol=0)
        np.testing.assert_allclose(got["snr"], ref["snr"], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got["mag"], ref["mag"], rtol=1e-5,
                                   atol=1e-6)
        ok = ~(np.isnan(got["freq"]) & np.isnan(ref["freq"]))
        np.testing.assert_allclose(got["freq"][ok], ref["freq"][ok], rtol=0,
                                   atol=50.0)
    else:
        np.testing.assert_allclose(got["mag"], ref["mag"], rtol=2e-7)
        np.testing.assert_allclose(got["snr"], ref["snr"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["freq"], ref["freq"], rtol=0,
                                   atol=3.0)


@pytest.fixture(scope="module")
def pdw_runs(captures, tmp_path_factory):
    """``pdw`` of the port on every container and of the JAX package on the
    ``.iq`` and ``.bin`` captures, wideband and channelized."""
    d = tmp_path_factory.mktemp("pdw")
    out = {}
    for mode, flags in (("wideband", ["--max-pulse-samples", "2048"]),
                        ("channelized", ["--channelized", "--bands", "8",
                                         "--max-pulse-samples", "1024"])):
        for kind in CONTAINERS:
            npz = str(d / f"{mode}_{kind}.npz")
            assert main(["pdw", captures[kind], "--out", npz, "--device",
                         "cpu"] + flags) == 0
            out[mode, kind] = dict(np.load(npz))
        for kind in ("iq", "bin"):
            npz = str(d / f"jax_{mode}_{kind}.npz")
            assert jmain(["pdw", captures[kind], "--out", npz] + flags) == 0
            out["jax", mode, kind] = dict(np.load(npz))
    return out


@pytest.mark.parametrize("mode", ["wideband", "channelized"])
@pytest.mark.parametrize("kind", CONTAINERS)
def test_cli_pdw_reads_every_container(pdw_runs, mode, kind):
    got = pdw_runs[mode, kind]
    # one payload, one path: raw containers give the .iq run's PDWs bit for
    # bit, float containers the normalised .npz run's
    same_as = "iq" if kind in RAW else "npz" if kind in FLOAT else "bin"
    for key, val in pdw_runs[mode, same_as].items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)
    ref = pdw_runs["jax", mode, "bin" if kind == "bin" else "iq"]
    _assert_pdws_close(got, ref, mode == "channelized")
    sel = (got["snr"] > 25) & (np.abs(got["freq"] - 2.4e9 - 2.0e6) < 0.5e6)
    assert int(sel.sum()) == 4  # 2 ms of a 500 us PRI


def test_cli_pdw_png_is_the_jax_png(tmp_path, captures, capsys):
    pngs = {}
    for name, fn, extra in (("t", main, ["--device", "cpu"]), ("j", jmain,
                                                                [])):
        png = str(tmp_path / f"{name}.png")
        printed = _run(fn, ["pdw", captures["mat_raw"], "--channelized",
                            "--bands", "8", "--max-pulse-samples", "1024",
                            "--out", str(tmp_path / f"{name}.npz"), "--png",
                            png] + extra, capsys)
        assert printed[-1] == png
        pngs[name] = png_size(png)
    assert pngs["t"] == pngs["j"]


def test_cli_predict_on_converted_dwells_with_png(tmp_path, capsys):
    """Three dwells of a full-scale scanning beam as a raw ``.npz``, a
    normalised v5 ``.mat`` and a raw v7.3 ``.mat``: the port's ``predict``
    prints the lines of its own run on the ``.iq`` files and of the JAX
    CLI on the same containers, and ``--png`` writes the JAX plot's size."""
    from sdr_channelizer_tpu_torch.capture import EmulatedRadio
    from sdr_channelizer_tpu_torch.cli.main import record_dwells
    from sdr_channelizer_tpu_torch.config import CaptureConfig

    from test_torch_capture import EVENT_ATOL_S, SCENE, _event_lines

    cfg = CaptureConfig(frequency_mhz=1000, bandwidth_mhz=8,
                        sample_rate_msps=1, rx_gain_db=60, dwell_sec=0.08,
                        duration_sec=0.24)
    os.makedirs(tmp_path / "d")
    scene = {**SCENE, "rel_amplitude": 1.0, "scan_phase_sec": 0.06}
    files = record_dwells(EmulatedRadio(**scene, start_epoch=100.0), cfg,
                          str(tmp_path / "d"))
    converted = []
    for path, flags in zip(files, (["--raw"], ["--mat"],
                                   ["--mat", "--v73", "--raw"])):
        converted += _run(main, ["convert", path, "--out-dir",
                                 str(tmp_path / "c")] + flags, capsys)
    common = ["--max-pulses", "32"]
    lines = {}
    for name, fn, paths, extra in (
            ("iq", main, files, ["--device", "cpu"]),
            ("port", main, converted, ["--device", "cpu", "--png",
                                       str(tmp_path / "t.png")]),
            ("jax", jmain, converted, ["--png", str(tmp_path / "j.png")])):
        assert fn(["predict", *paths] + common + extra) == 0
        lines[name] = _event_lines(capsys.readouterr().out)
    stem = {os.path.basename(p).rsplit(".", 1)[0] for p in files}
    for name in lines:
        lines[name] = {k.rsplit(".", 1)[0]: v for k, v in lines[name].items()}
        assert set(lines[name]) <= stem
    assert lines["port"] == lines["iq"] and len(lines["port"]) >= 2
    assert lines["port"].keys() == lines["jax"].keys()
    for k in lines["port"]:
        np.testing.assert_allclose(lines["port"][k], lines["jax"][k], rtol=0,
                                   atol=EVENT_ATOL_S)
    assert png_size(tmp_path / "t.png") == png_size(tmp_path / "j.png")


@pytest.mark.parametrize("extra", [[], ["--barker13", "--delay-samples", "37"]])
def test_cli_txrx_writes_the_jax_files(tmp_path, capsys, extra):
    argv = ["txrx", "1000", "8", "8", "0", "0.01", "0.004", "10e-6", "1e-3"] \
        + extra
    got = _run(main, argv + ["--out-dir", str(tmp_path / "t")], capsys)
    ref = _run(jmain, argv + ["--out-dir", str(tmp_path / "j")], capsys)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in ref] and len(got) == 2
    for p, q in zip(got, ref):
        with open(p, "rb") as f, open(q, "rb") as g:
            assert f.read() == g.read()
