"""End-to-end pipelines (single device).

``ChannelizerPipeline`` is the reference's offline analysis chain
(``matlab/convert_my_iq_to_mat.m`` -> ``create_pdws_channelized.m``):
capture in, channelized spectra, per-band noise floors and pulse descriptor
words out.  ``forward_packed`` / ``extract_fused`` are the main path: the
recorder's integer payload goes to the device as it is on disk and runs
through the four hand-written kernels.  ``forward`` / ``extract`` are the
port's own end-to-end oracle over the FFT channelizer and sort-based
medians.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple, Union

import numpy as np
import torch

from sdr_channelizer_tpu_torch._device import resolve_device
from sdr_channelizer_tpu_torch.config import PdwConfig
from sdr_channelizer_tpu_torch.dsp import pdw as pdwmod
from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer, channelize
from sdr_channelizer_tpu_torch.dsp.pdw import PdwBatch
from sdr_channelizer_tpu_torch.ops import cuda as kernels
from sdr_channelizer_tpu_torch.ops.medians import median

_UNPORTED_ROUTES = ("cm", "flat", "cm2c", "cm2g")


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
        (M,), PdwBatch) over the FFT channelizer."""
        y = channelize(x, self.channelizer, device=self.device)
        nf = median(y.abs(), dim=0)
        batch = pdwmod.extract_pdws_channelized(y, self.pdw_cfg,
                                                noise_floor=nf)
        return y, nf, batch

    def forward_packed(
        self, xq, bit_width: int, route: str = "cm2", plain: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, PdwBatch]:
        """The main path's step on the raw recorder payload.

        ``xq`` is the (N, 2) int16 I/Q buffer viewed as one int32 plane, or
        the (N, 2) int8 buffer viewed as one int16 plane: the on-disk bytes
        go to the device untouched, deinterleave and dequantization happen
        in the channelizer kernel.  Returns ``(noise_floor (M,), mag_cm
        (M, T), PdwBatch)``.

        ``route``: only ``"cm2"`` (or ``"auto"``, which means it) is
        ported.  ``plain=True`` runs the kernels' plain PyTorch versions on
        the same device instead of the kernels, for checking one against
        the other; nothing takes that path by itself.
        """
        if route in _UNPORTED_ROUTES:
            raise NotImplementedError(
                f"route {route!r} is not ported yet: only the 'cm2' route "
                f"exists in sdr_channelizer_tpu_torch")
        if route not in ("cm2", "auto"):
            raise ValueError(f"unknown route {route!r}")
        if self.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "torch.backends.cuda.matmul.allow_tf32 was switched on: the "
                "main path needs full-float32 products")
        ops = kernels.PLAIN if plain else kernels.KERNELS
        with warnings.catch_warnings():
            # a payload read from disk may be read-only; it is never written
            warnings.simplefilter("ignore", UserWarning)
            xq = torch.as_tensor(xq).to(self.device)
        m = self.channelizer.num_bands
        t_len = xq.shape[-1] // m
        mag_cm, dph_cm, satcs_cm = ops.channelize(
            xq, self.channelizer.taps_rev, bit_width=bit_width,
            sat_level=self.pdw_cfg.saturation_level)
        nf = pdwmod.noise_floor_cm(mag_cm, m, t_len, ops=ops)
        batch = pdwmod._extract_channelized_cm2(
            mag_cm, dph_cm, satcs_cm, self.pdw_cfg, nf, t_len, m, ops=ops)
        return nf, mag_cm, batch

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
        """Raw (N, 2) integer payload -> host PDW dict via the main path.

        int16 payloads go as the packed int32 plane and int8 payloads as
        the packed int16 plane (views of the on-disk bytes)."""
        samples = np.ascontiguousarray(samples)
        if samples.ndim != 2 or samples.shape[1] != 2:
            raise ValueError("samples must be an (N, 2) I/Q payload")
        if samples.dtype == np.int16:
            xq = samples.view(np.int32).ravel()
        elif samples.dtype == np.int8:
            xq = samples.view(np.int16).ravel()
        else:
            raise NotImplementedError(
                f"not ported yet: {samples.dtype} payloads (only int16 and "
                f"int8 recordings take the packed path)")
        _, _, batch = self.forward_packed(xq, bit_width=bit_width,
                                          plain=plain)
        return self._finalize(batch, fs, fc, sample_start_time)

    def extract(
        self,
        x,
        fs: float,
        fc: float = 0.0,
        sample_start_time: float = 0.0,
    ) -> dict:
        """Complex capture -> host PDW dict through the oracle step
        (absolute TOAs in epoch seconds, absolute frequencies with per-bin
        offsets)."""
        _, _, batch = self.forward(x)
        return self._finalize(batch, fs, fc, sample_start_time)
