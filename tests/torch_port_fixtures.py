"""Shared inputs of the ``test_torch_*`` files: captures made with NumPy
from a seed, handed to both the JAX package and the PyTorch port."""

import numpy as np

from sdr_channelizer_tpu.io import iqpacket
from sdr_channelizer_tpu.signal.synth import PulseTrainSpec, pulse_train

M = 8


def pulse_capture(bit_width=12, m=M, clip=True, seed=7):
    """About 8000 samples of a pulsed tone in noise, as an (N, 2) integer
    payload, N a multiple of ``m``; with ``clip`` a short full-scale
    segment, so that the saturation count is exercised."""
    spec = PulseTrainSpec(sample_rate_sps=8e6, duration_sec=1e-3,
                          frequency_hz=1.7e6, pulse_width_sec=60e-6,
                          pri_sec=300e-6, start_index=101, noise_std=5e-3)
    iq = pulse_train(spec, seed=seed)
    samples = iqpacket.from_complex(iq, bit_width)
    n = len(iq) // m * m
    samples = np.ascontiguousarray(samples[:n])
    if clip:
        samples[3000:3040] = np.iinfo(samples.dtype).max if bit_width in (8, 16) \
            else (1 << (bit_width - 1)) - 1
    return samples


def packed(samples):
    """The (N, 2) payload viewed as one plane of packed (I, Q) pairs."""
    dt = np.int16 if samples.dtype == np.int8 else np.int32
    return np.ascontiguousarray(samples).view(dt).ravel()
