"""The port's capture containers against the JAX package's: ``.npz`` arrays
bit for bit, ``.mat`` (v5 and v7.3, raw and normalised) read by each package
from the other's files to the same arrays and metadata with equal v7.3
prologues, the legacy ``.bin`` reader, and ``load_capture[_raw]`` on all
four containers."""

import os

import numpy as np
import pytest

from sdr_channelizer_tpu.io import convert as jconv
from sdr_channelizer_tpu_torch.io import convert as tconv
from sdr_channelizer_tpu_torch.io import iqpacket as tiq
from torch_port_fixtures import same_load, same_value


def _write_iq(path, fmt=3, bit_width=12, n=2000, seed=0):
    """About 2 ms at 1 Msps of random I/Q over the full scale of the bit
    width, written by the port's codec as format ``fmt``."""
    rng = np.random.default_rng(seed + 10 * fmt + bit_width)
    dt = np.int8 if bit_width <= 8 else np.int16
    lim = 1 << (bit_width - 1)
    samples = rng.integers(-lim, lim, size=(n, 2)).astype(dt)
    hdr = tiq.IqHeader(
        frequency_hz=2.4e9, bandwidth_hz=1e6, sample_rate_sps=1e6,
        rx_gain_db=42.5 if fmt >= 3 else 42.0, num_samples=n,
        bit_width=bit_width, sample_start_time=1723800000.125,
        link_speed=5000, board_name="bladeRF2micro", serial_number="abc123",
        fpga_version="0.15.3", fw_version="2.4.0", file_format=fmt)
    tiq.write_iq(path, hdr, samples)
    return samples


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("bit_width", [8, 12, 16])
@pytest.mark.parametrize("fmt", [1, 2, 3])
def test_iq_to_npz_is_the_jax_npz(tmp_path, fmt, bit_width, normalize):
    src = tmp_path / "cap.iq"
    _write_iq(src, fmt, bit_width)
    hdr = tconv.iq_to_npz(src, tmp_path / "t.npz", normalize=normalize)
    jhdr = jconv.iq_to_npz(src, tmp_path / "j.npz", normalize=normalize)
    assert hdr.file_format == jhdr.file_format == fmt
    t, j = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(t.files) == sorted(j.files)
    assert ("iq" in t.files) == normalize and ("iq_raw" in t.files) != normalize
    for k in t.files:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("v73", [False, True])
def test_mat_files_read_the_same_in_both_packages(tmp_path, v73, normalize,
                                                  writer):
    src = tmp_path / "cap.iq"
    samples = _write_iq(src, 3, 12)
    mat = tmp_path / "cap.mat"
    (tconv if writer == "port" else jconv).iq_to_mat(
        src, mat, normalize=normalize, v73=v73)
    got, ref = tconv.read_mat(mat), jconv.read_mat(mat)
    same_load(got, ref)
    np.testing.assert_array_equal(got[0], tiq.to_complex(samples, 12))
    assert got[1]["serialNumber"] == "abc123" and got[1]["bitWidth"] == 12
    raw, jraw = tconv.read_mat_raw(mat), jconv.read_mat_raw(mat)
    same_load(raw, jraw)
    if normalize:
        assert raw == (None, 0, None)
    else:
        np.testing.assert_array_equal(raw[0], samples)
        assert raw[0].dtype == np.int16 and raw[1] == 12


@pytest.mark.parametrize("normalize", [True, False])
def test_v73_prologue_is_the_jax_prologue(tmp_path, normalize):
    src = tmp_path / "cap.iq"
    _write_iq(src, 3, 12)
    tconv.iq_to_mat(src, tmp_path / "t.mat", normalize=normalize, v73=True)
    jconv.iq_to_mat(src, tmp_path / "j.mat", normalize=normalize, v73=True)
    t, j = (open(tmp_path / f, "rb").read(512) for f in ("t.mat", "j.mat"))
    assert t == j and t.startswith(b"MATLAB 7.3 MAT-file")
    from scipy.io.matlab import matfile_version

    assert matfile_version(str(tmp_path / "t.mat"))[0] == 2


def test_legacy_bin_reads_as_the_jax_reader_reads(tmp_path):
    rng = np.random.default_rng(4)
    path = tmp_path / "56M_2400_MHz_7.bin"
    rng.standard_normal(2 * 1000 + 1).astype("<f4").tofile(path)  # odd tail
    got, ref = tconv.read_legacy_bin(path), jconv.read_legacy_bin(path)
    same_value(got[0], ref[0])
    assert got[1:] == ref[1:] == (56e6, 2400e6, 7)
    bad = tmp_path / "capture.bin"
    bad.write_bytes(b"\0" * 16)
    for mod in (tconv, jconv):
        with pytest.raises(ValueError, match="does not match"):
            mod.read_legacy_bin(bad)


CONTAINERS = ["iq", "npz_raw", "npz", "mat_raw", "mat", "mat73_raw", "mat73",
              "bin"]


def make_container(tmp_path, kind: str, bit_width: int = 12) -> str:
    """One capture in the container ``kind``, written by the port."""
    src = str(tmp_path / "cap.iq")
    if not os.path.exists(src):
        _write_iq(src, 3, bit_width)
    if kind == "iq":
        return src
    if kind == "bin":
        iq = tiq.to_complex(tiq.read_iq(src)[1], bit_width)
        path = str(tmp_path / "1M_2400_MHz_0.bin")
        np.stack([iq.real, iq.imag], -1).astype("<f4").tofile(path)
        return path
    stem, _, raw = kind.partition("_")
    path = str(tmp_path / f"{kind}.{'npz' if stem == 'npz' else 'mat'}")
    if stem == "npz":
        tconv.iq_to_npz(src, path, normalize=not raw)
    else:
        tconv.iq_to_mat(src, path, normalize=not raw, v73=stem == "mat73")
    return path


@pytest.mark.parametrize("kind", CONTAINERS)
def test_load_capture_on_every_container(tmp_path, kind):
    path = make_container(tmp_path, kind)
    got, ref = tconv.load_capture(path), jconv.load_capture(path)
    same_load(got, ref)
    assert got[0].dtype == np.complex64 and len(got[0]) == 2000
    samples = tiq.read_iq(str(tmp_path / "cap.iq"))[1]
    np.testing.assert_allclose(got[0], tiq.to_complex(samples, 12), rtol=0,
                               atol=0 if kind != "bin" else 1e-7)
    raw, jraw = tconv.load_capture_raw(path), jconv.load_capture_raw(path)
    same_load(raw, jraw)
    if kind in ("iq", "npz_raw", "mat_raw", "mat73_raw"):
        np.testing.assert_array_equal(raw[0], samples)
        assert raw[0].dtype == np.int16 and raw[1] == 12
        assert raw[2]["fs"] == 1e6
    else:
        assert raw == (None, 0, None)


@pytest.mark.parametrize("kind", CONTAINERS)
def test_load_capture_payload_reads_each_container_once(tmp_path, kind,
                                                        monkeypatch):
    """The one-read loader gives the raw payload where the container has one
    and the JAX package's ``load_capture`` samples where it has not, and
    parses a ``.mat`` once."""
    path = make_container(tmp_path, kind)
    parses = []
    real = tconv._mat_vars
    monkeypatch.setattr(tconv, "_mat_vars",
                        lambda p: parses.append(p) or real(p))
    raw, bit_width, iq, meta = tconv.load_capture_payload(path)
    assert len(parses) == (1 if path.endswith(".mat") else 0)
    jraw = jconv.load_capture_raw(path)
    if jraw[0] is not None:
        assert iq is None and bit_width == jraw[1]
        same_value(raw, jraw[0])
    else:
        jiq, jmeta = jconv.load_capture(path)
        assert raw is None and bit_width == 0
        same_value(iq, jiq)
        jraw = (None, 0, jmeta)
    for key in ("fs", "fc", "sampleStartTime"):
        assert meta[key] == jraw[2][key]


def test_unknown_container_is_refused(tmp_path):
    path = tmp_path / "cap.wav"
    path.write_bytes(b"")
    with pytest.raises(ValueError, match="unsupported capture container"):
        tconv.load_capture(path)
    assert tconv.load_capture_raw(path) == (None, 0, None)
