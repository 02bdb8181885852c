"""PNG renderers for the reference's visual outputs.

* :func:`plot_iq_png` — magnitude + phase vs time with a shared x-axis
  (``plot_my_iq.m:119-136``).
* :func:`waterfall_png` — channelizer magnitude waterfall; the reference
  renders an MPEG-4 surf video (``channelizer_example.m:36-75``), here a
  single time-frequency mesh.
* :func:`pdw_plot_png` — PDW frequency and pulse width vs TOA scatter
  (``create_pdws.m:110-120``).
* :func:`event_fit_png` — SNR-vs-TOA samples with the fitted parabola and
  the event/next-event markers (``predict_event.m:20-29,140-150``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_iq_png(path, iq: np.ndarray, fs: float, title: Optional[str] = None) -> None:
    plt = _plt()
    t = np.arange(len(iq)) / fs * 1e3
    fig, (ax1, ax2) = plt.subplots(2, 1, sharex=True, figsize=(10, 6), dpi=100)
    ax1.plot(t, np.abs(iq), lw=0.4)
    ax1.set_ylabel("Magnitude")
    if title:
        ax1.set_title(title)
    ax2.plot(t, np.rad2deg(np.angle(iq)), ",", ms=1)
    ax2.set_ylabel("Phase (deg)")
    ax2.set_xlabel("Time (ms)")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def waterfall_png(
    path,
    chan_mag: np.ndarray,  # (T, M) channel magnitudes (fftshifted order)
    fs: float,
    fc: float = 0.0,
    db: bool = True,
    title: Optional[str] = None,
) -> None:
    plt = _plt()
    t_frames, m = chan_mag.shape
    t = np.arange(t_frames) * m / fs * 1e3
    f = (np.fft.fftshift(np.fft.fftfreq(m)) * fs + fc) * 1e-6
    z = 20 * np.log10(np.maximum(chan_mag, 1e-9)) if db else chan_mag
    fig, ax = plt.subplots(figsize=(10, 6), dpi=100)
    im = ax.pcolormesh(f, t, z, shading="nearest", cmap="viridis", rasterized=True)
    ax.set_xlabel("Frequency (MHz)")
    ax.set_ylabel("Time (ms)")
    if title:
        ax.set_title(title)
    fig.colorbar(im, ax=ax, label="Magnitude (dB)" if db else "Magnitude")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def waterfall_window_pngs(
    out_dir,
    iq: np.ndarray,
    fs: float,
    num_bands: int,
    fc: float = 0.0,
    window_sec: float = 5e-3,
    step_samples: Optional[int] = None,
    limit: Optional[int] = None,
    device=None,
) -> list:
    """The reference's waterfall *video* as a PNG sequence.

    ``channelizer_example.m:33-75`` channelizes 5 ms windows stepped by
    ``100 * numBands`` samples and renders each as a video frame; here each
    window becomes one PNG (``frame_%05d.png``).  On a CUDA device each
    window goes through ``channelize_planes`` (the channelizer kernel's
    complex form, one launch a window) and only the magnitude, formed on the
    device, comes back; on the CPU through the FFT oracle.  Returns the
    paths.
    """
    import os

    import torch

    from sdr_channelizer_tpu_torch._device import resolve_device
    from sdr_channelizer_tpu_torch.dsp.channelizer import (
        Channelizer,
        channelize,
        channelize_planes,
    )

    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    chan = Channelizer.create(num_bands)
    win = int(window_sec * fs) // num_bands * num_bands
    step = step_samples if step_samples is not None else 100 * num_bands
    paths = []
    starts = range(0, max(len(iq) - win, 0) + 1, step)
    for k, s in enumerate(starts):
        if limit is not None and k >= limit:
            break
        w = iq[s : s + win]
        if device.type == "cuda":
            yr, yi = channelize_planes(
                np.ascontiguousarray(np.real(w), np.float32),
                np.ascontiguousarray(np.imag(w), np.float32), chan,
                device=device)
            y = torch.sqrt(yr * yr + yi * yi).cpu().numpy()
        else:
            y = channelize(w, chan, method="fft", device=device).abs().numpy()
        p = os.path.join(out_dir, f"frame_{k:05d}.png")
        waterfall_png(p, y, fs, fc, title=f"t = {s / fs * 1e3:.2f} ms")
        paths.append(p)
    return paths


def waterfall_video(
    out_path,
    frame_paths: list,
    fps: float = 20.0,
) -> str:
    """Assemble a PNG frame sequence into an MPEG-4 video — the one-command
    equivalent of the reference's waterfall video
    (``channelizer_example.m:36-75`` renders surf frames into a
    ``VideoWriter(..., 'MPEG-4')``).

    Uses the ``ffmpeg`` binary when present, else OpenCV's ``VideoWriter``
    (mp4v).  Returns the written path.
    """
    import os
    import shutil
    import subprocess

    if not frame_paths:
        raise ValueError("no frames to assemble")
    out_path = os.fspath(out_path)
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg:
        # Frames are frame_%05d.png in one directory (waterfall_window_pngs).
        pattern = os.path.join(os.path.dirname(frame_paths[0]),
                               "frame_%05d.png")
        subprocess.run(
            [ffmpeg, "-y", "-loglevel", "error", "-framerate", str(fps),
             "-i", pattern, "-pix_fmt", "yuv420p", out_path],
            check=True,
        )
        return out_path
    import cv2

    first = cv2.imread(frame_paths[0])
    if first is None:
        raise ValueError(f"cannot read frame {frame_paths[0]!r}")
    h, w = first.shape[:2]
    # mp4v needs even dimensions; crop a pixel if necessary.
    h -= h % 2
    w -= w % 2
    writer = cv2.VideoWriter(
        out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError("no MPEG-4 encoder available (ffmpeg or OpenCV)")
    try:
        for p in frame_paths:
            img = cv2.imread(p)
            if img is None:
                raise ValueError(f"cannot read frame {p!r}")
            writer.write(img[:h, :w])
    finally:
        writer.release()
    return out_path


def pdw_plot_png(path, pdws: dict, title: Optional[str] = None) -> None:
    plt = _plt()
    t = np.asarray(pdws["toa"])
    t0 = t.min() if t.size else 0.0
    fig, (ax1, ax2) = plt.subplots(2, 1, sharex=True, figsize=(10, 6), dpi=100)
    ax1.plot(t - t0, np.asarray(pdws["freq"]) * 1e-6, ".", ms=3)
    ax1.set_ylabel("Frequency (MHz)")
    if title:
        ax1.set_title(title)
    ax2.plot(t - t0, np.asarray(pdws["pw"]) * 1e6, ".", ms=3)
    ax2.set_ylabel("Pulse width (us)")
    ax2.set_xlabel(f"TOA - {t0:.6f} (s)")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def event_fit_png(
    path,
    toa: np.ndarray,
    snr: np.ndarray,
    event_time: Optional[float] = None,
    next_event_time: Optional[float] = None,
    title: Optional[str] = None,
    fits: Optional[np.ndarray] = None,
) -> None:
    """The ``predict_event.m:20-29,140-150`` live diagnostic as a PNG:
    pulse samples (blue dots), the quadratic SNR(t) fit parabola, each
    capture's fitted ``(t_max, y_max)`` peak (``fits``, red stars —
    ``hCurrEventPlot``), and the current/next event markers."""
    plt = _plt()
    toa = np.asarray(toa, float)
    snr = np.asarray(snr, float)
    fig, ax = plt.subplots(figsize=(10, 6), dpi=100)
    ax.plot(toa, snr, ".", ms=4, label="pulses")
    if toa.size >= 3:
        c = np.polyfit(toa - toa.mean(), snr, 2)
        tt = np.linspace(toa.min(), toa.max(), 200)
        ax.plot(tt, np.polyval(c, tt - toa.mean()), "-", label="quadratic fit")
    if fits is not None and np.asarray(fits).size:
        f = np.asarray(fits, float).reshape(-1, 2)
        ax.plot(f[:, 0], f[:, 1], "r*", ms=9, label="fitted events")
    if event_time is not None:
        ax.axvline(event_time, color="tab:green", ls="--", label="event")
    if next_event_time is not None:
        ax.axvline(next_event_time, color="tab:red", ls=":", label="next event")
    ax.set_xlabel("TOA (s)")
    ax.set_ylabel("SNR (dB)")
    if title:
        ax.set_title(title)
    ax.legend()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
