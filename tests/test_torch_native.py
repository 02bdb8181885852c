"""The port's ctypes bindings of the native IqPacket codec, against the
library that ``make -C native`` builds and against both packages' NumPy
codecs and the JAX package's bindings: the same bytes written, the same
headers and samples read, the same UTC file names."""

import dataclasses
import shutil

import numpy as np
import pytest

from sdr_channelizer_tpu.io import iqpacket as jiq
from sdr_channelizer_tpu.io import native as jnative
from sdr_channelizer_tpu_torch.io import iqpacket as tiq
from sdr_channelizer_tpu_torch.io import native as tnative


@pytest.fixture(scope="module", autouse=True)
def built():
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no native toolchain")
    from conftest import build_native

    build_native()
    assert tnative.available() and jnative.available()


def _header(fmt=3, bit_width=12, big_endian=False):
    return tiq.IqHeader(
        frequency_hz=2.4e9 if fmt > 1 else 1.2e9, bandwidth_hz=56e6,
        sample_rate_sps=56e6, rx_gain_db=42.5 if fmt >= 3 else 42.0,
        num_samples=0, bit_width=bit_width,
        sample_start_time=1723800000.125, link_speed=5000,
        board_name="bladeRF2micro", serial_number="abc123",
        fpga_version="0.15.3", fw_version="2.4.0", file_format=fmt,
        big_endian=big_endian)


def _as_jax_header(hdr):
    return jiq.IqHeader(**dataclasses.asdict(hdr))


@pytest.mark.parametrize("fmt,bit_width", [(1, 16), (1, 8), (2, 12), (3, 12),
                                           (3, 8), (3, 16)])
def test_native_codec_is_both_packages_codec(tmp_path, fmt, bit_width):
    rng = np.random.default_rng(fmt * 100 + bit_width)
    dt = np.int8 if bit_width <= 8 else np.int16
    lim = 2 ** (bit_width - 1)
    samples = rng.integers(-lim, lim, size=(1000, 2)).astype(dt)
    hdr = _header(fmt, bit_width)
    paths = {name: tmp_path / f"{name}.iq"
             for name in ("port_native", "port_numpy", "jax_native")}
    tnative.write_iq(paths["port_native"], hdr, samples)
    tiq.write_iq(paths["port_numpy"], hdr, samples)
    jnative.write_iq(paths["jax_native"], _as_jax_header(hdr), samples)
    data = {name: p.read_bytes() for name, p in paths.items()}
    assert data["port_native"] == data["port_numpy"] == data["jax_native"]

    path = paths["port_native"]
    h_nat, s_nat = tnative.read_iq(path)
    h_np, s_np = tiq.read_iq(path)
    h_jn, s_jn = jnative.read_iq(path)
    assert isinstance(h_nat, tiq.IqHeader)
    assert h_nat == h_np
    assert dataclasses.asdict(h_nat) == dataclasses.asdict(h_jn)
    for s in (np.asarray(s_np), s_jn):
        np.testing.assert_array_equal(s_nat, s)
    assert s_nat.dtype == dt and s_nat.shape == (1000, 2)
    h_parsed, off = tnative.parse_header(data["port_native"])
    assert (h_parsed, off) == tiq.parse_header(data["port_native"])


def test_native_reads_big_endian_files(tmp_path):
    hdr = _header(fmt=2, bit_width=12, big_endian=True)
    samples = np.arange(64, dtype=np.int16).reshape(32, 2)
    p = tmp_path / "be.iq"
    tiq.write_iq(p, hdr, samples)
    h_cc, s_cc = tnative.read_iq(p)
    h_py, s_py = tiq.read_iq(p)
    assert h_cc.big_endian and h_cc.file_format == 2 and h_cc == h_py
    np.testing.assert_array_equal(np.asarray(s_py, np.int16), s_cc)
    np.testing.assert_array_equal(s_cc, jnative.read_iq(p)[1])


@pytest.mark.parametrize("epoch", [0.0, 1723800000.125, 1723800000.9996])
def test_native_filename_is_the_codecs_filename(epoch):
    assert tnative.filename_utc(epoch) == tiq.utc_filename(epoch) \
        == jnative.filename_utc(epoch)


def test_native_writer_checks_the_payload(tmp_path):
    hdr = _header(3, 12)
    with pytest.raises(ValueError, match=r"\(N, 2\)"):
        tnative.write_iq(tmp_path / "x.iq", hdr, np.zeros(8, np.int16))
    with pytest.raises(ValueError, match="dtype"):
        tnative.write_iq(tmp_path / "x.iq", hdr, np.zeros((8, 2), np.int8))


def test_unavailable_without_the_library(monkeypatch):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_LIB_PATHS", ("/nonexistent/libiqpacket.so",
                                                ""))
    assert not tnative.available()
