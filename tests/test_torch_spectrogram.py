"""The port's spectrogram against the JAX package's: the window bit for bit,
``stft_power`` in both forms and ``stft_power_packed`` on int16 and int8
pairs at the reference's bars (``tests/test_spectrogram.py:71``, ``:94``),
the axes and the PNG."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sdr_channelizer_tpu.config import SpectrogramConfig as JConfig
from sdr_channelizer_tpu.dsp import spectrogram as jsg
from sdr_channelizer_tpu.io import iqpacket as jiq
from sdr_channelizer_tpu_torch.config import SpectrogramConfig
from sdr_channelizer_tpu_torch.dsp import spectrogram as tsg
from sdr_channelizer_tpu_torch.dsp.channelizer import resolve_method
from torch_port_fixtures import png_size

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6          # tests/test_spectrogram.py:94
DFT_RTOL, DFT_ATOL = 2e-4, 1e-4  # tests/test_spectrogram.py:71
# On float noise a few bins far below the mesh's peak differ by up to 4e-5
# relative between XLA's and torch's float32 FFTs and products (each sums
# in its own order, and |X|^2 of a small bin keeps little relative
# accuracy); those comparisons hold every bin within 1e-5 of the largest
# power, the bar chip_smoke.py holds the card's mesh to.
MESH_TOL = 1e-5


def _iq(n=4096, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def test_config_is_the_jax_config():
    assert SpectrogramConfig() == SpectrogramConfig(768, 0)
    assert (SpectrogramConfig().window_length, SpectrogramConfig().overlap) \
        == (JConfig().window_length, JConfig().overlap)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("length", [8, 256, 768])
def test_hamming_has_the_jax_bits(length, dtype):
    a, b = tsg.hamming(length, dtype), jsg.hamming(length, dtype)
    assert a.dtype == b.dtype == dtype
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("method", ["fft", "dft"])
def test_stft_power_matches_jax(method):
    """At the reference's own case (window 256); a ragged tail dropped."""
    iq = _iq(256 * 16 + 100)
    got = tsg.stft_power(iq, cfg=SpectrogramConfig(256), method=method,
                         device="cpu")
    ref = np.asarray(jsg.stft_power(jnp.asarray(iq), cfg=JConfig(256),
                                    method=method))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (16, 256)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                               atol=MESH_TOL * ref.max())


def numpy_stft_power(iq, length):
    """The float64 oracle: windowed frames, FFT, ``fftshift``, |.|^2."""
    w = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(length) / (length - 1))
    frames = iq[: len(iq) // length * length].astype(np.complex128)
    spec = np.fft.fft(frames.reshape(-1, length) * w, axis=-1)
    return np.abs(np.fft.fftshift(spec, axes=-1)) ** 2


@pytest.mark.parametrize("method", ["fft", "dft"])
def test_stft_power_at_window_768_against_float64(method):
    """At the default window both packages stay within 1e-5 of the largest
    power of a float64 STFT, and of each other."""
    iq = _iq(768 * 6)
    got = tsg.stft_power(iq, method=method, device="cpu").numpy()
    ref = np.asarray(jsg.stft_power(jnp.asarray(iq), method=method))
    want = numpy_stft_power(iq, 768)
    for p in (got, ref):
        assert np.abs(p - want).max() <= MESH_TOL * want.max()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=MESH_TOL * ref.max())


def test_stft_dft_matches_fft_and_auto_is_fft_on_the_cpu():
    iq = _iq()
    cfg = SpectrogramConfig(window_length=256)
    a = tsg.stft_power(iq, cfg=cfg, method="fft", device="cpu")
    b = tsg.stft_power(iq, cfg=cfg, method="dft", device="cpu")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=DFT_RTOL,
                               atol=DFT_ATOL)
    auto = tsg.stft_power(iq, cfg=cfg, device="cpu")
    assert torch.equal(auto, a)


def test_resolve_method_keys_on_the_device():
    assert resolve_method("auto", "cpu") == "fft"
    assert resolve_method("auto", torch.device("cuda")) == "dft"
    assert resolve_method("fft", "cuda:0") == "fft"
    assert resolve_method("dft", "cpu") == "dft"


def test_explicit_window_matches_jax():
    iq = _iq(1000, seed=2)
    w = np.hanning(100)  # float64: folded into the DFT matrix, then cast
    for method in ("fft", "dft"):
        got = tsg.stft_power(iq, window=w, method=method, device="cpu")
        ref = np.asarray(jsg.stft_power(jnp.asarray(iq), window=w,
                                        method=method))
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bit_width,view", [(12, np.int32), (16, np.int32),
                                            (8, np.int16)])
def test_stft_power_packed_matches_jax(bit_width, view):
    cfg = SpectrogramConfig(window_length=256)
    samples = jiq.from_complex(_iq(256 * 8, seed=3, scale=0.4), bit_width)
    packed = np.ascontiguousarray(samples).view(view).ravel()
    got = tsg.stft_power_packed(packed, bit_width, cfg=cfg, device="cpu")
    ref = np.asarray(jsg.stft_power_packed(jnp.asarray(packed), bit_width,
                                           cfg=JConfig(256)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    # and the port's float form on the dequantized capture
    deq = jiq.to_complex(samples, bit_width)
    want = tsg.stft_power(deq, cfg=cfg, method="dft", device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_stft_power_packed_refuses_unpacked_payloads():
    with pytest.raises(TypeError, match="int32 or int16"):
        tsg.stft_power_packed(np.zeros(1024, np.float32), 12, device="cpu")


def test_tone_lands_on_its_bin_with_the_windows_gain():
    fs, cfg = 768e3, SpectrogramConfig()
    f = 100 * fs / cfg.window_length
    x = np.exp(2j * np.pi * f * np.arange(cfg.window_length * 10) / fs
               ).astype(np.complex64)
    p = tsg.stft_power(x, cfg=cfg, device="cpu").numpy()
    _, faxis = tsg.axes_for(10, fs, 0.0, cfg)
    peak = int(np.argmax(p.mean(axis=0)))
    assert faxis[peak] == pytest.approx(f)
    w = tsg.hamming(cfg.window_length, np.float64)
    assert p[:, peak].mean() == pytest.approx(np.sum(w) ** 2, rel=1e-3)


def test_axes_are_the_jax_axes():
    for got, ref in zip(tsg.axes_for(7, 56e6, 2.4e9),
                        jsg.axes_for(7, 56e6, 2.4e9)):
        np.testing.assert_array_equal(got, ref)


def test_save_png_has_the_jax_pixel_size(tmp_path):
    x = _iq(768 * 5)
    power = tsg.stft_power(x, device="cpu")
    tsg.save_png(tmp_path / "t.png", power, fs=768e3, fc=1e9, title="t")
    jsg.save_png(tmp_path / "j.png", np.asarray(jsg.stft_power(x)),
                 fs=768e3, fc=1e9, title="t")
    assert png_size(tmp_path / "t.png") == png_size(tmp_path / "j.png")
