"""End-to-end pipelines (single device).

``ChannelizerPipeline`` is the reference's offline analysis chain
(``matlab/convert_my_iq_to_mat.m`` -> ``create_pdws_channelized.m``):
capture in, channelized spectra, per-band noise floors and pulse descriptor
words out.  ``forward_packed`` / ``extract_fused`` are the main path: the
recorder's integer payload goes to the device as it is on disk and runs
through the hand-written kernels; ``forward_fused`` is the same step on two
sample planes (float payloads).  ``forward`` is the port's own end-to-end
oracle over the channelizer's default form (the FFT on the CPU, the
channelizer kernel's complex form on the card, as ``method="auto"`` is in
the JAX package) and sort-based medians, ``forward_planes`` the
complex-free form of it.  ``WidebandPdwPipeline`` is the detector
without a channelizer (``create_pdws.m``).

Routes of the fused steps: ``"cm2"`` (and ``"auto"``, which means it) is the
channel-major route with the saturation as a running count; ``"cm"`` the
channel-major route with the time-major magnitude beside it (the streamed
block's form, single-shot); ``"flat"`` the time-major streams, flipped by
the flip kernel in the tail.

Staged steps (the JAX package's ``jax.jit`` sites, ``_staging``): ``step``,
``step_planes`` and ``step_fused`` are ``forward``, ``forward_planes`` and
``forward_fused`` captured once a key as CUDA graphs and replayed;
``extract_fused`` runs a staged ``forward_packed`` (``bit_width`` and
``route`` static).  ``forward*`` are the eager forms, and so is every call
with ``plain=True``.  On the CPU a staged step calls its eager form.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from sdr_channelizer_tpu_torch._device import resolve_device, to_device
from sdr_channelizer_tpu_torch._staging import Staged
from sdr_channelizer_tpu_torch.config import PdwConfig
from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
from sdr_channelizer_tpu_torch.dsp.channelizer import (
    Channelizer,
    channelize,
    channelize_planes,
)
from sdr_channelizer_tpu_torch.dsp.pdw import PdwBatch
from sdr_channelizer_tpu_torch.ops import cuda as kernels
from sdr_channelizer_tpu_torch.ops.medians import median

ROUTES = ("auto", "cm2", "cm", "flat")
# A/B knobs of the JAX package's cm2 tail (slot compaction, slot gating):
# tuning of its statistics kernel for its hardware, with no counterpart here
_AB_KNOB_ROUTES = ("cm2c", "cm2g")


def _check_route(route: str) -> str:
    if route in _AB_KNOB_ROUTES:
        raise NotImplementedError(
            f"route {route!r} is an A/B knob of the JAX package's cm2 tail "
            f"and does not carry over to sdr_channelizer_tpu_torch; the "
            f"routes are {ROUTES}")
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; the routes are {ROUTES}")
    return "cm2" if route == "auto" else route


@dataclasses.dataclass
class ChannelizerPipeline:
    """Channelize -> per-band median noise floor -> PDW extraction.

    ``device`` is where every step runs: the CUDA device unless the caller
    asked for ``"cpu"`` (``create`` raises when it is left to default and no
    card is present).
    """

    channelizer: Channelizer
    pdw_cfg: PdwConfig
    device: torch.device

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.device.type == "cuda":
            # full-float32 products on the whole path
            torch.backends.cuda.matmul.allow_tf32 = False
        # the JAX package's jax.jit wrappers (models/pipeline.py:186-193)
        statics = ("bit_width", "route")
        self._staged_forward = Staged(self.forward, self.device)
        self._staged_forward_planes = Staged(self.forward_planes, self.device)
        self._staged_forward_fused = Staged(self.forward_fused, self.device,
                                            statics)
        self._staged_forward_packed = Staged(self.forward_packed,
                                             self.device, statics)

    @classmethod
    def create(
        cls,
        num_bands: int,
        pdw_cfg: Optional[PdwConfig] = None,
        device: Optional[Union[str, torch.device]] = None,
        **chan_kwargs,
    ) -> "ChannelizerPipeline":
        return cls(
            channelizer=Channelizer.create(num_bands, **chan_kwargs),
            pdw_cfg=pdw_cfg or PdwConfig.channelized(),
            device=resolve_device(device),
        )

    @classmethod
    def from_reference(
        cls,
        taps_rev: np.ndarray,
        pdw_cfg: dict,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "ChannelizerPipeline":
        """Build the pipeline from parameters handed over as plain values:
        the (P, M) frame-aligned polyphase taps as a NumPy array and the
        ``PdwConfig`` fields as a dict (``dataclasses.asdict``)."""
        return cls(
            channelizer=Channelizer.from_taps(taps_rev),
            pdw_cfg=PdwConfig(**pdw_cfg),
            device=resolve_device(device),
        )

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, PdwBatch]:
        """The oracle step: complex capture -> (chan_iq (T, M), noise floor
        (M,), PdwBatch) over the channelizer's default form."""
        y = channelize(x, self.channelizer, device=self.device)
        nf = median(y.abs(), dim=0)
        batch = pdwmod.extract_pdws_channelized(y, self.pdw_cfg,
                                                noise_floor=nf)
        return y, nf, batch

    def forward_planes(self, xr, xi):
        """The oracle step without a complex dtype: float32 sample planes
        -> (yr, yi (T, M), noise floor (M,), PdwBatch).  The numbers of
        :meth:`forward` with the DFT extraction."""
        yr, yi = channelize_planes(xr, xi, self.channelizer,
                                   device=self.device)
        mag, ph, sat = pdwmod._prep_streams_planes(
            yr, yi, self.pdw_cfg.saturation_level)
        nf = median(mag, dim=0)
        batch = pdwmod.extract_pdws_channelized_streams(
            mag, ph, sat, self.pdw_cfg, noise_floor=nf)
        return yr, yi, nf, batch

    def _fused_tail(self, route: str, front, ops):
        """Noise floor and extraction behind the channelizer kernel's
        ``route`` form; ``front(stage)`` runs that form's stage."""
        cfg = self.pdw_cfg
        m = self.channelizer.num_bands
        if route == "cm2":
            mag_cm, dph_cm, satcs_cm = front("cm2")
            t_len = mag_cm.shape[1]
            nf = pdwmod.noise_floor_cm(mag_cm, m, t_len, ops=ops)
            batch = pdwmod._extract_channelized_cm2(
                mag_cm, dph_cm, satcs_cm, cfg, nf, t_len, m, ops=ops)
            return nf, mag_cm, batch
        if route == "cm":
            mag, *cm = front("cm")
        else:
            # flipped once, ahead of the floor; the tail takes the flip
            mag, ph, sat = front("flat")
            cm = ops.cm_streams(mag, ph, sat)   # B5's 0/1 mask as it is
        nf = pdwmod.noise_floor_cm(cm[0], m, mag.shape[0], ops=ops)
        batch = pdwmod._extract_channelized_pallas_stats(
            mag, None, None, cfg, nf, cm_streams=tuple(cm), ops=ops)
        return nf, mag, batch

    def _check_products(self) -> None:
        if self.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "torch.backends.cuda.matmul.allow_tf32 was switched on: the "
                "main path needs full-float32 products")

    def forward_packed(
        self, xq, bit_width: int, route: str = "auto", plain: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, PdwBatch]:
        """The main path's step on the raw recorder payload.

        ``xq`` is the (N, 2) int16 I/Q buffer viewed as one int32 plane, or
        the (N, 2) int8 buffer viewed as one int16 plane: the on-disk bytes
        go to the device untouched, deinterleave and dequantization happen
        in the channelizer kernel.  Returns ``(noise_floor (M,), mag,
        PdwBatch)``; ``mag`` is the channel-major (M, T) magnitude on route
        ``"cm2"`` and the time-major (T, M) one on ``"cm"`` and ``"flat"``.

        ``route``: see the module docstring.  ``plain=True`` runs the
        kernels' plain PyTorch versions on the same device instead of the
        kernels, for checking one against the other; nothing takes that
        path by itself.
        """
        route = _check_route(route)
        self._check_products()
        ops = kernels.PLAIN if plain else kernels.KERNELS
        xq = to_device(xq, self.device)
        stages = {"cm2": ops.channelize, "cm": ops.channelize_cm,
                  "flat": ops.channelize_flat}
        return self._fused_tail(route, lambda stage: stages[stage](
            xq, self.channelizer.taps_rev, bit_width=bit_width,
            sat_level=self.pdw_cfg.saturation_level), ops)

    def forward_fused(
        self, xr, xi, bit_width: int = 0, route: str = "auto",
        plain: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, PdwBatch]:
        """:meth:`forward_packed` on two sample planes: int16 raw planes
        (``bit_width`` set) or float32 normalized ones (``bit_width=0``)."""
        route = _check_route(route)
        self._check_products()
        ops = kernels.PLAIN if plain else kernels.KERNELS
        xr, xi = to_device(xr, self.device), to_device(xi, self.device)
        stages = {"cm2": ops.channelize_planes, "cm": ops.channelize_cm_planes,
                  "flat": ops.channelize_flat_planes}
        return self._fused_tail(route, lambda stage: stages[stage](
            xr, xi, self.channelizer.taps_rev, bit_width=bit_width,
            sat_level=self.pdw_cfg.saturation_level), ops)

    def step(self, x):
        """:meth:`forward`, staged."""
        return self._staged_forward(x)

    def step_planes(self, xr, xi):
        """:meth:`forward_planes`, staged."""
        return self._staged_forward_planes(xr, xi)

    def step_fused(self, xr, xi, bit_width: int = 0):
        """:meth:`forward_fused` on route ``"cm2"``, staged."""
        self._check_products()   # as the eager form does; a replay cannot
        return self._staged_forward_fused(xr, xi, bit_width=bit_width,
                                          route="cm2")

    def _step_packed(self, xq, bit_width: int, route: str = "auto"):
        """:meth:`forward_packed`, staged: the JAX package's
        ``_jit_forward_packed``."""
        self._check_products()
        return self._staged_forward_packed(xq, bit_width=bit_width,
                                           route=_check_route(route))

    def _finalize(self, batch: PdwBatch, fs, fc, sample_start_time) -> dict:
        return pdwmod.finalize_pdws(
            batch,
            fs=fs / self.channelizer.num_bands,
            fc=fc,
            sample_start_time=sample_start_time,
            bin_offsets_hz=self.channelizer.center_frequencies(fs),
        )

    def extract_fused(
        self,
        samples: np.ndarray,
        bit_width: int,
        fs: float,
        fc: float = 0.0,
        sample_start_time: float = 0.0,
        plain: bool = False,
    ) -> dict:
        """Raw (N, 2) payload -> host PDW dict via the main path.

        int16 payloads go as the packed int32 plane and int8 payloads as
        the packed int16 plane (views of the on-disk bytes); float payloads
        go as two float32 planes.  Each goes through the staged step, the
        host payload copied straight into the graph's input; ``plain=True``
        runs the eager step on the plain versions."""
        samples = np.ascontiguousarray(samples)
        if samples.ndim != 2 or samples.shape[1] != 2:
            raise ValueError("samples must be an (N, 2) I/Q payload")
        if samples.dtype in (np.int16, np.int8):
            wide = np.int32 if samples.dtype == np.int16 else np.int16
            xq = samples.view(wide).ravel()
            _, _, batch = (
                self.forward_packed(xq, bit_width=bit_width, plain=True)
                if plain else self._step_packed(xq, bit_width=bit_width))
        elif np.issubdtype(samples.dtype, np.floating):
            xr = np.ascontiguousarray(samples[:, 0], np.float32)
            xi = np.ascontiguousarray(samples[:, 1], np.float32)
            _, _, batch = (
                self.forward_fused(xr, xi, bit_width=bit_width, plain=True)
                if plain else self.step_fused(xr, xi, bit_width=bit_width))
        else:
            raise TypeError(f"samples must be int16, int8 or float, got "
                            f"{samples.dtype}")
        return self._finalize(batch, fs, fc, sample_start_time)

    def extract_planes(
        self,
        iq: np.ndarray,
        fs: float,
        fc: float = 0.0,
        sample_start_time: float = 0.0,
    ) -> dict:
        """Host complex capture -> host PDW dict via the complex-free step
        (the planes are split on the host)."""
        iq = np.asarray(iq)
        xr = np.ascontiguousarray(iq.real, np.float32)
        xi = np.ascontiguousarray(iq.imag, np.float32)
        _, _, _, batch = self.step_planes(xr, xi)
        return self._finalize(batch, fs, fc, sample_start_time)

    def extract(
        self,
        x,
        fs: float,
        fc: float = 0.0,
        sample_start_time: float = 0.0,
    ) -> dict:
        """Complex capture -> host PDW dict (absolute TOAs in epoch
        seconds, absolute frequencies with per-bin offsets).

        On the card this is the fused step on the capture's two float32
        planes (:meth:`extract_fused`), as in the JAX package off the CPU;
        on the CPU it is the oracle step over the FFT channelizer.  The two
        agree to the last place of a float32."""
        if self.device.type == "cuda":
            iq = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
                else np.asarray(x)
            samples = np.stack([iq.real, iq.imag], -1).astype(np.float32)
            return self.extract_fused(samples, bit_width=0, fs=fs, fc=fc,
                                      sample_start_time=sample_start_time)
        _, _, batch = self.step(x)
        return self._finalize(batch, fs, fc, sample_start_time)


@dataclasses.dataclass
class WidebandPdwPipeline:
    """Full-rate PDW extraction, no channelizer (``create_pdws.m``): the
    noise floor is the median magnitude of the whole capture, 18 dB leading
    / 3 dB trailing hysteresis by default.

    ``device`` as in :class:`ChannelizerPipeline`: the CUDA device unless the
    caller asked for ``"cpu"``.  On the card the extraction takes the kernel
    tail (the one-channel streams made from the capture in one kernel, the
    time-major latch and the statistics kernel at one channel; block by
    block from 2^24 samples on, with the flip kernel a block), on the CPU
    the oracle tail.  ``step`` and ``extract`` replay a captured CUDA graph
    of :meth:`forward` below 2^24 samples, and from 2^24 on one a block of
    the blocked tail (``_staging``).
    """

    pdw_cfg: PdwConfig = dataclasses.field(default_factory=PdwConfig.wideband)
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        # the JAX package's jax.jit wrapper (models/pipeline.py:308), and
        # the blocked tail's block step
        self._staged_forward = Staged(self.forward, self.device)
        self._staged_block = Staged(self._block, self.device,
                                    ("own_len", "end"))

    @classmethod
    def from_reference(
        cls,
        pdw_cfg: dict,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "WidebandPdwPipeline":
        """Build the pipeline from the ``PdwConfig`` fields handed over as a
        dict (``dataclasses.asdict``); wideband extraction has no weights."""
        return cls(pdw_cfg=PdwConfig(**pdw_cfg), device=device)

    def forward(self, x,
                plain: bool = False) -> Tuple[torch.Tensor, PdwBatch]:
        """Complex capture -> (noise floor, PdwBatch).  ``plain=True`` runs
        the kernels' plain PyTorch versions on the same device, for checking
        one against the other."""
        ops = kernels.PLAIN if plain else kernels.KERNELS
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        return pdwmod.extract_pdws_with_floor(x, self.pdw_cfg, ops=ops)

    def _block(self, mag_e, ph_e, sat_e, nf, entry, *, own_len: int,
               end: bool):
        """One block of the blocked tail through the kernels
        (``dsp.pdw._wideband_block``)."""
        return pdwmod._wideband_block(mag_e, ph_e, sat_e, nf, entry,
                                      cfg=self.pdw_cfg, own_len=own_len,
                                      end=end)

    def step(self, x) -> Tuple[torch.Tensor, PdwBatch]:
        """:meth:`forward`, staged.  Below 2^24 samples the whole step is
        one graph.  From 2^24 samples on the card the tail goes block by
        block and brings the blocks' pulses to the host once, to compact
        them there (``dsp.pdw._extract_wideband_blocked``), which one graph
        cannot hold: the streams and the floor run eagerly, each block's
        step is staged, and the latch entry is chained on the device."""
        if not hasattr(x, "shape"):
            x = np.asarray(x)
        if x.shape[-1] < pdwmod._WIDEBAND_BLOCKED_FROM:
            return self._staged_forward(x)
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.complex64)
        if pdwmod._wideband_tail("auto", x, x.shape[-1]) != "blocked":
            return self.forward(x)   # the oracle tail, on the CPU
        cfg = self.pdw_cfg
        mag, phase_deg, sat = pdwmod._prep_streams(x, cfg.saturation_level)
        nf = pdwmod.noise_floor_1d(mag, ops=kernels.KERNELS)
        return nf, pdwmod._extract_wideband_blocked(
            mag, phase_deg, sat, cfg, nf, block_step=self._staged_block)

    def extract(
        self,
        x,
        fs: float,
        fc: float = 0.0,
        sample_start_time: float = 0.0,
        plain: bool = False,
    ) -> dict:
        """Complex capture -> host PDW dict, through :meth:`step` (or the
        eager plain versions with ``plain=True``)."""
        _, batch = self.forward(x, plain=True) if plain else self.step(x)
        return pdwmod.finalize_pdws(batch, fs=fs, fc=fc,
                                    sample_start_time=sample_start_time)
