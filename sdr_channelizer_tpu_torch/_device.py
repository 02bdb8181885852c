"""Device policy of the port: the card unless the caller asks for the CPU."""

from __future__ import annotations

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
