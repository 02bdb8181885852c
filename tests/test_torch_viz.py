"""The port's plots against the JAX package's: the waterfall windows' frame
names, count and the magnitudes they render (rtol = atol = 1e-5,
``tests/test_pallas_kernel.py:24``), every PNG at the JAX package's pixel
size, and the waterfall video (its OpenCV branch where there is no
``ffmpeg``)."""

import os

import numpy as np
import pytest
import torch

from sdr_channelizer_tpu.viz import plots as jplots
from sdr_channelizer_tpu_torch.viz import plots as tplots
from torch_port_fixtures import png_size

torch.set_num_threads(1)

FS = 8e6
M = 8
MAG_TOL = 1e-5


def _iq(n=16000, seed=1):
    """2 ms at 8 Msps: a pulsed tone in noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    iq = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    on = (t % 4000) < 800
    iq = iq + on * 0.5 * np.exp(2j * np.pi * 1.3e6 / FS * t)
    return iq.astype(np.complex64)


def _captured(monkeypatch, mod):
    """Replace ``mod.waterfall_png`` by a recorder of what it is given."""
    seen = []
    monkeypatch.setattr(mod, "waterfall_png",
                        lambda p, y, *a, **k: seen.append((p, y, a, k)))
    return seen


def test_waterfall_windows_render_the_jax_magnitudes(tmp_path, monkeypatch):
    iq = _iq()
    kw = dict(fc=2.4e9, window_sec=0.5e-3, limit=4)
    got = _captured(monkeypatch, tplots)
    ref = _captured(monkeypatch, jplots)
    tplots.waterfall_window_pngs(tmp_path / "t", iq, FS, M, device="cpu",
                                 **kw)
    jplots.waterfall_window_pngs(tmp_path / "j", iq, FS, M, **kw)
    assert len(got) == len(ref) == 4
    for (p, y, a, k), (q, z, b, l) in zip(got, ref):
        assert os.path.basename(p) == os.path.basename(q)
        assert (a, k) == (b, l)  # fs, fc and the title
        assert y.shape == z.shape == (500, M)
        np.testing.assert_allclose(y, z, rtol=MAG_TOL, atol=MAG_TOL)


def test_waterfall_windows_write_the_jax_frames(tmp_path):
    iq = _iq()
    kw = dict(window_sec=0.5e-3, step_samples=2400, limit=2)
    got = tplots.waterfall_window_pngs(tmp_path / "t", iq, FS, M,
                                       device="cpu", **kw)
    ref = jplots.waterfall_window_pngs(tmp_path / "j", iq, FS, M, **kw)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in ref] == ["frame_00000.png",
                                                "frame_00001.png"]
    for p, q in zip(got, ref):
        assert png_size(p) == png_size(q)


def test_waterfall_windows_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tplots.waterfall_window_pngs("unused", _iq(), FS, M)


def _pdws(seed=0):
    rng = np.random.default_rng(seed)
    return {"toa": np.sort(rng.uniform(100.0, 100.1, 40)),
            "freq": rng.uniform(-2e6, 2e6, 40),
            "pw": rng.uniform(10e-6, 100e-6, 40)}


def _plot(mod, kind, path):
    iq = _iq(4000)
    if kind == "iq":
        mod.plot_iq_png(path, iq, FS, title="cap")
    elif kind == "waterfall":
        mag = np.abs(iq[: 4000 // M * M].reshape(-1, M))
        mod.waterfall_png(path, mag, FS, 2.4e9, title="cap")
    elif kind == "pdw":
        mod.pdw_plot_png(path, _pdws(), title="cap")
    else:
        toa = np.linspace(0.0, 0.08, 30)
        snr = 30.0 - 2000.0 * (toa - 0.05) ** 2
        mod.event_fit_png(path, toa, snr, event_time=0.05,
                          next_event_time=0.55, title="cap",
                          fits=np.array([[0.05, 30.0]]))


@pytest.mark.parametrize("kind", ["iq", "waterfall", "pdw", "event"])
def test_plots_have_the_jax_pixel_size(tmp_path, kind):
    _plot(tplots, kind, tmp_path / "t.png")
    _plot(jplots, kind, tmp_path / "j.png")
    assert png_size(tmp_path / "t.png") == png_size(tmp_path / "j.png")


def test_waterfall_video_takes_opencv_without_ffmpeg(tmp_path, monkeypatch):
    import shutil

    import cv2

    monkeypatch.setattr(shutil, "which", lambda name: None)
    frames = tplots.waterfall_window_pngs(
        tmp_path / "f", _iq(), FS, M, window_sec=0.5e-3, limit=3,
        device="cpu")
    out = {}
    for name, mod in (("t", tplots), ("j", jplots)):
        path = str(tmp_path / f"{name}.mp4")
        assert mod.waterfall_video(path, frames, fps=10.0) == path
        cap = cv2.VideoCapture(path)
        out[name] = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                     int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                     int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
        cap.release()
    assert out["t"] == out["j"] and out["t"][0] == 3
    with pytest.raises(ValueError, match="no frames"):
        tplots.waterfall_video(tmp_path / "x.mp4", [])
