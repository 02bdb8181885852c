"""Device policy of the port: the card unless the caller asks for the CPU."""

from __future__ import annotations

import warnings
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the CUDA device and raises when there is none; nothing
    falls back to the CPU silently.  ``"cpu"`` is honoured only because the
    caller asked for it (the CPU tests do)."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sdr_channelizer_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' explicitly to use the plain "
            "PyTorch versions on the host")
    return device


def to_device(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or a host array) as a tensor on ``device``, without
    the warning ``torch.as_tensor`` gives for a read-only array: a payload
    read from disk may be read-only, and it is never written."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.as_tensor(x).to(device)
