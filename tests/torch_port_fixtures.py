"""Shared inputs of the ``test_torch_*`` files: captures made with NumPy
from a seed, handed to both the JAX package and the PyTorch port."""

import struct

import numpy as np

from sdr_channelizer_tpu.io import iqpacket
from sdr_channelizer_tpu.signal.synth import PulseTrainSpec, pulse_train

M = 8

PDW_FIELDS = ("toa_idx", "te_idx", "pw_sec", "mag", "snr_db", "freq_offset_hz",
              "saturated", "valid", "count")


def assert_pdw_field(field, got, ref):
    """Every ``PdwBatch`` field bit for bit, but ``snr_db``: ``torch.log10``
    and XLA's ``log10`` differ in the last place, so it is held at 1e-5 dB."""
    if field == "snr_db":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5, err_msg=field)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=field)


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


def png_size(path):
    """(width, height) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        data = f.read(24)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", data[16:24])


def same_value(a, b, key=""):
    if isinstance(a, str) or isinstance(b, str):
        assert type(a) is type(b) and a == b, key
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, key
    np.testing.assert_array_equal(a, b, err_msg=key)


def _same_meta(a, b):
    if a is None or b is None:
        assert a is b
        return
    assert sorted(a) == sorted(b)
    for k in a:
        same_value(a[k], b[k], k)


def same_load(got, ref):
    """Two ``load_capture[_raw]`` results: arrays bit for bit, same dtypes,
    same metadata."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if isinstance(g, dict) or g is None:
            _same_meta(g, r)
        else:
            same_value(g, r)
