"""Polyphase analysis channelizer: the port's plain-PyTorch oracle.

Same behaviour as MATLAB ``dsp.Channelizer(M)`` as used by the reference
(``matlab/create_pdws_channelized.m:29-62``): input truncated to a multiple
of M, output ``(N/M, M)`` with channel ``k`` the band centred at
``center_frequencies(M, fs)[k]``, zero initial filter state.

Frame convention (output row ``n`` consumes input frame ``n`` fully):

    y[n, k]   = sum_rho e^{-j 2 pi k rho / M} u[n, rho]
    u[n, rho] = sum_p  Hr[p, rho] F[n - p, rho]

with frames ``F[n, rho] = x[nM + rho]`` and the frame-aligned polyphase taps
``Hr[p, rho] = h[pM + (M-1-rho)]``.  The CUDA channelizer kernel's plain
version is checked against this module.  On a CUDA device the DFT-product
form (``method="dft"``, what ``"auto"`` means there, and
``channelize_planes``) runs in the channelizer kernel's complex form; the
FFT form (what ``"auto"`` means on the CPU) stays the oracle everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sdr_channelizer_tpu_torch._device import resolve_device
from sdr_channelizer_tpu_torch.config import ChannelizerConfig
from sdr_channelizer_tpu_torch.ops import filters


def center_frequencies(num_bands: int, sample_rate_sps: float) -> np.ndarray:
    """Ascending channel centre frequencies, aligned with fftshifted output."""
    return np.fft.fftshift(np.fft.fftfreq(num_bands)) * sample_rate_sps


def dft_matrix(num_bands: int, shifted: bool = True, dtype=np.complex64) -> np.ndarray:
    """Forward DFT matrix ``W[rho, k] = exp(-2j pi rho k / M)``; with
    ``shifted`` the columns are reordered so ``u @ W`` equals
    ``fftshift(fft(u), axes=-1)``."""
    m = int(num_bands)
    rho = np.arange(m)[:, None]
    k = np.arange(m)[None, :]
    w = np.exp(-2j * np.pi * rho * k / m)
    if shifted:
        w = w[:, np.fft.fftshift(np.arange(m))]
    return w.astype(dtype)


@dataclasses.dataclass(frozen=True)
class ChannelizerState:
    """Carried streaming state: the last P frames of input (zeros at the
    start of a capture)."""

    frames: torch.Tensor  # (P, M) complex64


@dataclasses.dataclass(frozen=True)
class Channelizer:
    """Configured polyphase channelizer; ``taps_rev`` is the frame-aligned
    polyphase matrix ``Hr`` (P, M) float32."""

    num_bands: int
    taps_per_band: int
    taps_rev: np.ndarray

    @classmethod
    def create(
        cls,
        num_bands: int,
        taps_per_band: int = 12,
        stopband_atten_db: float = 80.0,
        prototype: Optional[np.ndarray] = None,
    ) -> "Channelizer":
        if prototype is None:
            prototype = filters.design_prototype_filter(
                num_bands, taps_per_band, stopband_atten_db
            )
        hr = filters.reversed_polyphase(np.asarray(prototype, np.float64), num_bands)
        return cls(
            num_bands=num_bands,
            taps_per_band=hr.shape[0],
            taps_rev=np.ascontiguousarray(hr.astype(np.float32)),
        )

    @classmethod
    def from_config(cls, cfg: ChannelizerConfig) -> "Channelizer":
        return cls.create(cfg.num_bands, cfg.taps_per_band, cfg.stopband_atten_db)

    @classmethod
    def from_taps(cls, taps_rev: np.ndarray) -> "Channelizer":
        """Wrap an existing (P, M) frame-aligned tap matrix."""
        taps_rev = np.ascontiguousarray(np.asarray(taps_rev, np.float32))
        return cls(num_bands=taps_rev.shape[1], taps_per_band=taps_rev.shape[0],
                   taps_rev=taps_rev)

    def init_state(self, device=None) -> ChannelizerState:
        p, m = self.taps_rev.shape
        return ChannelizerState(frames=torch.zeros(
            (p, m), dtype=torch.complex64, device=resolve_device(device)))

    def __call__(self, x, shift: bool = True, method: str = "auto",
                 device=None) -> torch.Tensor:
        return channelize(x, self, shift=shift, method=method, device=device)

    def stream_block(self, x_block, state: ChannelizerState,
                     shift: bool = True, method: str = "auto"):
        """Channelize one block carrying the filter history across calls;
        returns ``(y (T, M) complex64, new state)``.  The block runs on the
        state's device; on a CUDA device the DFT form is the channelizer
        kernel's complex form, seeded with the state's frames.

        Splitting a capture into blocks and folding them through
        ``stream_block`` gives the output of one :func:`channelize` call bit
        for bit: the overlap-save contract of the streamed path."""
        return _channelize_block(x_block, state, self.taps_rev,
                                 self.num_bands, shift, method)

    def center_frequencies(self, sample_rate_sps: float) -> np.ndarray:
        return center_frequencies(self.num_bands, sample_rate_sps)

    def decimated_rate(self, sample_rate_sps: float) -> float:
        return sample_rate_sps / self.num_bands


def fir_branches(frames: torch.Tensor, taps_rev: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Polyphase branch FIR over (..., T, M) frames, as P shifted
    multiply-adds: ``u[n] = sum_p Hr[p] * F[n - p]``.  ``history`` holds
    the (P', M) frames before the first one, P' >= P-1 (the last P-1 are
    used); default zeros, the initial state."""
    p = taps_rev.shape[0]
    t = frames.shape[-2]
    if history is None:
        head = frames.new_zeros((*frames.shape[:-2], p - 1, frames.shape[-1]))
    else:
        if history.shape[-2] < p - 1:
            raise ValueError(f"history needs at least {p - 1} frames")
        head = history[..., history.shape[-2] - (p - 1):, :].to(frames.dtype)
    padded = torch.cat([head, frames], dim=-2)
    u = torch.zeros_like(frames)
    for pp in range(p):
        u = u + taps_rev[pp] * padded[..., p - 1 - pp: p - 1 - pp + t, :]
    return u


def resolve_method(method: str = "auto", device=None) -> str:
    """Pick the channel-extraction form for tensors on ``device`` (``None``:
    the card).

    ``"fft"`` -- ``torch.fft.fft`` + ``fftshift``: the oracle, and the form
    for the CPU.  ``"dft"`` -- the product with the shift-folded DFT matrix,
    the form of the kernels on a CUDA device.  ``"auto"`` means ``"fft"``
    on the CPU and ``"dft"`` on a CUDA device."""
    if method != "auto":
        return method
    device = torch.device("cuda" if device is None else device)
    return "dft" if device.type == "cuda" else "fft"


def channelize(x, chan: Channelizer, shift: bool = True, method: str = "auto",
               device=None) -> torch.Tensor:
    """Channelize a complex capture (..., N); returns ``(..., N // M, M)``
    complex64, each leading index a capture of its own.

    ``method``: ``"fft"`` (the oracle), ``"dft"`` (product with the
    shift-folded DFT matrix, the form the kernel computes; on a CUDA device
    the channelizer kernel computes it, one launch a capture) or ``"auto"``
    (:func:`resolve_method`)."""
    device = resolve_device(device)
    method = resolve_method(method, device)
    m = chan.num_bands
    x = torch.as_tensor(x).to(device=device, dtype=torch.complex64)
    lead = x.shape[:-1]
    n_frames = x.shape[-1] // m
    x = x[..., : n_frames * m]
    if method == "dft" and device.type == "cuda":
        from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel

        if not lead:
            return channelizer_kernel.channelize_complex(
                x.contiguous(), chan.taps_rev, shift)
        rows = x.reshape(lead.numel(), n_frames * m).contiguous()
        y = torch.empty((rows.shape[0], n_frames, m), dtype=torch.complex64,
                        device=device)
        for r in range(rows.shape[0]):
            y[r] = channelizer_kernel.channelize_complex(
                rows[r], chan.taps_rev, shift)
        return y.reshape(*lead, n_frames, m)
    frames = x.reshape(*lead, n_frames, m)
    taps = torch.as_tensor(chan.taps_rev, device=device)
    return _bands(fir_branches(frames, taps), m, shift, method)


def channelize_planes(xr, xi, chan: Channelizer, shift: bool = True,
                      device=None):
    """Channelize with no complex dtype on the way in: 1-D float32 sample
    planes -> ``(yr, yi)``, each ``(N // M, M)`` float32, the numbers of
    ``channelize(..., method="dft")``: the branch FIR on each plane and the
    DFT as four real products, ``yr = ur Wr - ui Wi``, ``yi = ur Wi + ui
    Wr``.  On a CUDA device the channelizer kernel computes them."""
    from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel

    device = resolve_device(device)
    xr, xi = (torch.as_tensor(v).to(device=device, dtype=torch.float32)
              .contiguous() for v in (xr, xi))
    y = channelizer_kernel.channelize_complex_planes(xr, xi, chan.taps_rev,
                                                     shift)
    return y.real, y.imag


def _bands(u: torch.Tensor, m: int, shift: bool, method: str) -> torch.Tensor:
    """Branch outputs (T, M) -> channel outputs, by FFT or DFT product."""
    if method == "dft":
        w = torch.as_tensor(dft_matrix(m, shifted=shift), device=u.device)
        return u @ w
    if method != "fft":
        raise ValueError(f"unknown method {method!r}")
    y = torch.fft.fft(u, dim=-1)
    return torch.fft.fftshift(y, dim=-1) if shift else y


def _channelize_block(x_block, state: ChannelizerState, taps_rev,
                      num_bands: int, shift: bool = True, method: str = "auto"):
    """One block of :meth:`Channelizer.stream_block`."""
    m = num_bands
    dev = state.frames.device
    method = resolve_method(method, dev)
    x = torch.as_tensor(x_block).to(device=dev, dtype=torch.complex64)
    n_frames = x.shape[-1] // m
    x = x[: n_frames * m].contiguous()
    frames = x.reshape(n_frames, m)
    taps = torch.as_tensor(np.asarray(taps_rev, np.float32), device=dev)
    p = taps.shape[0]
    if method == "dft" and dev.type == "cuda":
        from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel

        y = channelizer_kernel.channelize_complex(
            x, taps_rev, shift, history=state.frames[1:] if p > 1 else None)
    else:
        y = _bands(fir_branches(frames, taps, state.frames), m, shift, method)
    all_frames = torch.cat([state.frames, frames], dim=0)
    return y, ChannelizerState(frames=all_frames[all_frames.shape[0] - p:])
