"""Spectrogram / STFT power (``matlab/spectrogram_my_iq.m:114-129``).

Reference configuration: ``stft(iq, fs, 'Window', hamming(768),
'OverlapLength', 0)`` -- symmetric Hamming window, zero overlap, squared
magnitude power, frequency axis centred on the tuned frequency
(``y = (f + fc) MHz``), one PNG per capture.

Zero overlap makes the STFT a reshape -> window -> DFT.  On a CUDA device the
DFT is four float32 products with the window folded into the DFT matrix
(``torch.matmul``: the JAX package computes them in plain XLA, with no
Pallas kernel), and :func:`stft_power_packed` takes the raw recorder payload
(packed int16/int8 I/Q pairs) to the device, where the sign extension and
the dequantization run: the packed ingest of the PDW pipeline
(``models/pipeline.py::extract_fused``).  TF32 products are refused: with
them the mesh misses the reference's bar of rtol 1e-5.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from sdr_channelizer_tpu_torch._device import resolve_device, to_device
from sdr_channelizer_tpu_torch.config import SpectrogramConfig


def hamming(length: int, dtype=np.float32) -> np.ndarray:
    """Symmetric Hamming window, MATLAB ``hamming(L)`` semantics (computed
    in float64, then cast)."""
    n = np.arange(length, dtype=np.float64)
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (length - 1))
    return w.astype(dtype)


def _window(window, cfg: SpectrogramConfig) -> np.ndarray:
    return np.asarray(hamming(cfg.window_length) if window is None else window)


def _frames(x: torch.Tensor, length: int) -> torch.Tensor:
    frames = x.shape[-1] // length
    return x[..., : frames * length].reshape(*x.shape[:-1], frames, length)


def stft_power(
    iq,
    window: Optional[np.ndarray] = None,
    cfg: SpectrogramConfig = SpectrogramConfig(),
    method: str = "auto",
    device=None,
) -> torch.Tensor:
    """Squared-magnitude STFT with zero overlap.

    Returns ``(num_frames, window_length)`` float32 power on ``device``,
    frequency axis in FFT-shifted (ascending, DC-centred) order to match the
    reference's 'centered' display.  ``method`` follows
    :func:`dsp.channelizer.resolve_method`: ``"fft"`` is ``torch.fft``,
    ``"dft"`` the four real products of :func:`stft_power_packed`."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import resolve_method

    device = resolve_device(device)
    w = _window(window, cfg)
    length = w.shape[0]
    x = _frames(to_device(iq, device).to(torch.complex64), length)
    if resolve_method(method, device) == "dft":
        return _windowed_dft_power_planes(x.real, x.imag, length, w)
    wt = torch.as_tensor(w, dtype=torch.float32, device=device)
    spec = torch.fft.fftshift(torch.fft.fft(x * wt, dim=-1), dim=-1)
    return spec.abs().square()


@functools.lru_cache(maxsize=8)
def _windowed_dft(length: int, window: bytes, dtype: str,
                  device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shift-folded DFT matrix times the window, as float32 real and
    imaginary planes on ``device``.  Built once per window and device: on
    the host it takes far longer than the four products it feeds."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import dft_matrix

    w = np.frombuffer(window, dtype=dtype)
    wm = dft_matrix(length, shifted=True) * w[:, None]
    return (torch.as_tensor(np.real(wm).astype(np.float32), device=device),
            torch.as_tensor(np.imag(wm).astype(np.float32), device=device))


def _windowed_dft_power_planes(
    xr: torch.Tensor, xi: torch.Tensor, length: int, window: np.ndarray
) -> torch.Tensor:
    """(frames, L) float32 planes -> squared-magnitude DFT power, the window
    folded into the DFT matrix: four real float32 products."""
    if xr.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the spectrogram "
            "needs full-float32 products")
    wr, wi = _windowed_dft(length, window.tobytes(), window.dtype.str,
                           xr.device)
    sr = xr @ wr - xi @ wi
    si = xr @ wi + xi @ wr
    return sr * sr + si * si


def stft_power_packed(
    xq,
    bit_width: int,
    window: Optional[np.ndarray] = None,
    cfg: SpectrogramConfig = SpectrogramConfig(),
    device=None,
) -> torch.Tensor:
    """Packed-ingest spectrogram: raw recorder payload in, power mesh out.

    ``xq`` packs one interleaved (I, Q) pair per element -- int32 for int16
    payloads (``samples.view(np.int32)``), int16 for int8 payloads -- the
    same device ingest as ``extract_fused``; sign extension and the
    ``2^-(bit_width-1)`` Q-format dequantization run on ``device`` (no host
    float conversion).  Same values as :func:`stft_power` over the
    dequantized capture (``spectrogram_my_iq.m:92-98,114`` ingest + STFT
    semantics)."""
    from sdr_channelizer_tpu_torch.ops.cuda.channelizer_kernel import (
        unpack_pairs,
    )

    device = resolve_device(device)
    xq = to_device(xq, device)
    if xq.dtype not in (torch.int32, torch.int16):
        raise TypeError(f"xq must pack (I, Q) pairs as int32 or int16, got "
                        f"{xq.dtype}")
    w = _window(window, cfg)
    length = w.shape[0]
    i, q = unpack_pairs(_frames(xq, length))
    scale = 2.0 ** -(bit_width - 1)
    return _windowed_dft_power_planes(i * scale, q * scale, length, w)


def axes_for(
    num_frames: int, fs: float, fc: float, cfg: SpectrogramConfig = SpectrogramConfig()
) -> Tuple[np.ndarray, np.ndarray]:
    """(time_sec, freq_hz) axes; freq absolute (f + fc) ascending, as in
    ``spectrogram_my_iq.m:118-123``."""
    t = np.arange(num_frames) * cfg.window_length / fs
    f = np.fft.fftshift(np.fft.fftfreq(cfg.window_length)) * fs + fc
    return t, f


def save_png(
    path,
    power,
    fs: float,
    fc: float = 0.0,
    cfg: SpectrogramConfig = SpectrogramConfig(),
    db_floor: float = -120.0,
    title: Optional[str] = None,
) -> None:
    """Render the power mesh (a host array or a tensor) to a PNG (parity
    with the reference's per-file PNG export, ``spectrogram_my_iq.m:129``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(power, torch.Tensor):
        power = power.detach().cpu().numpy()
    power = np.asarray(power)
    t, f = axes_for(power.shape[0], fs, fc, cfg)
    db = 10.0 * np.log10(np.maximum(power, 10.0 ** (db_floor / 10.0)))
    fig, ax = plt.subplots(figsize=(10, 6), dpi=100)
    im = ax.pcolormesh(
        f * 1e-6, t * 1e3, db, shading="nearest", cmap="viridis", rasterized=True
    )
    ax.set_xlabel("Frequency (MHz)")
    ax.set_ylabel("Time (ms)")
    if title:
        ax.set_title(title)
    fig.colorbar(im, ax=ax, label="Power (dB)")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
