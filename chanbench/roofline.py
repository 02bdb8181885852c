"""The yardstick's arithmetic: the card's published peaks and the least
bytes and operations a capture's step must spend, from the configuration's
shapes.

Peaks: NVIDIA's H100 SXM data sheet (dense, no sparsity): HBM3 at 3.35 TB/s,
67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s dense TF32.  They
hold at the full 700 W; the harness prints the card's power limit beside
every share.

The least bytes of a step, whatever implements it: the recorder's payload
read once (I and Q in the configuration's ``payload_dtype``), plus the
``PdwBatch`` written once: each slot's leading and trailing index, width,
magnitude, SNR and frequency (4 bytes each), saturation and valid flags (1
byte each), and a count a band.  Every further pass over the capture or its
streams, the exact median's second look at the samples included, is the
implementation's, not the work's.

The least operations: the polyphase channelizer's, a real tap times a
complex sample in each of ``taps_per_band`` taps (4 flops a tap a sample)
and an M-point FFT a frame (5 log2 M flops a sample), in float32, as the
configuration states (TF32 off).  The detection after it (magnitudes, phase
differences, comparisons) is left uncounted: a few operations a sample,
under what these two cost.  A wideband step runs no channelizer and counts
none.  The least time is the larger of the bytes at the HBM rate and the
operations at the float32 rate; for the 56-band, 12-tap, int16 dwell the
bytes bind (4 bytes: 1.19 ps a sample; 77 flops: 1.15 ps).
"""

from __future__ import annotations

import math

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

SLOT_BYTES = 6 * 4 + 2           # six 4-byte fields, two flags
COUNT_BYTES = 4


def sample_bytes(cfg: dict) -> int:
    """Bytes of one complex sample of the payload: I and Q."""
    return 2 * np.dtype(cfg["payload_dtype"]).itemsize


def batch_bytes(cfg: dict) -> int:
    """One ``PdwBatch`` of the configuration: every band's slots and
    count."""
    bands = int(cfg.get("num_bands", 1))
    return bands * (int(cfg["max_pulses"]) * SLOT_BYTES + COUNT_BYTES)


def least_bytes(cfg: dict, samples: int, batches: int = 1) -> int:
    """Bytes a step over ``samples`` complex samples must move, which
    writes ``batches`` batches (a streamed segment writes one a block)."""
    return (sample_bytes(cfg) * int(samples)
            + int(batches) * batch_bytes(cfg))


def least_flops(cfg: dict, samples: int) -> float:
    """Float32 operations the channelizer must spend on ``samples``."""
    bands = int(cfg.get("num_bands", 1))
    if bands == 1:
        return 0.0
    per_sample = 4 * int(cfg["taps_per_band"]) + 5 * math.log2(bands)
    return per_sample * int(samples)


def least_seconds(cfg: dict, samples: int, batches: int = 1) -> float:
    """The least time of the step: its least bytes at the HBM rate or its
    least operations at the float32 rate, whichever is longer."""
    return max(least_bytes(cfg, samples, batches) / HBM_BYTES_PER_S,
               least_flops(cfg, samples) / FP32_FLOP_PER_S)
