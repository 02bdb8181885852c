"""Capture conversion and loading: the reference's MATLAB ingest scripts as
library functions, for every container the JAX package reads.

* :func:`iq_to_npz` -- ``convert_my_iq_to_mat.m`` parity: parse a versioned
  ``.iq`` file and save every header field plus the payload under the same
  variable names (``iq``, ``fs``, ``fc``, ``bw``, ``gain``, ``bitWidth``,
  ``sampleStartTime``, ...; ``convert_my_iq_to_mat.m:104-118``).
* :func:`iq_to_mat` -- the same as a MATLAB ``.mat``, v5 through
  ``scipy.io.savemat`` or v7.3 (HDF5, through ``h5py``).
* :func:`read_mat` / :func:`read_mat_raw` -- either ``.mat`` back, normalised
  or as the raw integer payload.
* :func:`read_legacy_bin` -- ``convert_iq_to_mat.m`` parity: the headerless
  float32 format with metadata encoded in the filename
  ``"<rate>M_<fc>_MHz_<n>.bin"`` (``convert_iq_to_mat.m:20-28``).
* :func:`load_capture` / :func:`load_capture_raw` -- any of ``.iq``,
  ``.npz``, ``.mat`` and ``.bin``.

The files written here have the JAX package's bytes and layout, so either
package reads the other's.  ``scipy`` and ``h5py`` are imported where they
are used.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np

from sdr_channelizer_tpu_torch.io import iqpacket


def header_vars(hdr: iqpacket.IqHeader) -> dict:
    """Header fields under the reference's .mat variable names."""
    return {
        "fs": float(hdr.sample_rate_sps),
        "fc": float(hdr.frequency_hz),
        "bw": float(hdr.bandwidth_hz),
        "gain": float(hdr.rx_gain_db),
        "bitWidth": int(hdr.bit_width),
        "numSamples": int(hdr.num_samples),
        "sampleStartTime": float(hdr.sample_start_time),
        "linkSpeed": int(hdr.link_speed),
        "boardName": hdr.board_name,
        "serialNumber": hdr.serial_number,
        "fpgaVersion": hdr.fpga_version,
        "fwVersion": hdr.fw_version,
        "fileFormat": int(hdr.file_format),
    }


def iq_to_npz(iq_path, npz_path, normalize: bool = True) -> iqpacket.IqHeader:
    """Convert one ``.iq`` file to ``.npz``.

    ``normalize=True`` stores complex64 in [-1, 1) (``iq / 2^(bitWidth-1)``,
    ``create_pdws.m:30-32``); ``False`` stores the raw integer (N, 2) I/Q.
    Asserts the payload length like the reference
    (``convert_my_iq_to_mat.m:102`` — enforced inside ``read_iq``).
    """
    hdr, samples = iqpacket.read_iq(iq_path)
    arrays = header_vars(hdr)
    if normalize:
        arrays["iq"] = iqpacket.to_complex(np.asarray(samples), hdr.bit_width)
    else:
        arrays["iq_raw"] = np.asarray(samples)
    np.savez(npz_path, **arrays)
    return hdr


def iq_to_mat(
    iq_path, mat_path, normalize: bool = True, v73: bool = False
) -> iqpacket.IqHeader:
    """Convert one ``.iq`` file to a MATLAB ``.mat``.

    ``normalize=False`` reproduces the reference converter's exact layout
    (``convert_my_iq_to_mat.m:118``): ``iq`` as the raw (2, N) int8/int16
    matrix plus ``fs/fc/dur/bw/gain/bitWidth/sampleStartTime/linkSpeed/
    boardName/serialNo/fpgaVersion/fwVersion`` — directly consumable by
    ``plot_my_iq.m:93-108`` / ``create_pdws.m:28-32``.  ``normalize=True``
    stores ``iq`` as normalized complex64 instead (convenience; the
    read-back path :func:`read_mat` accepts both).  ``v73=True`` writes a
    v7.3 (HDF5) container like the reference's ``save -v7.3``; default is
    the v5 container (both readable by MATLAB ``load`` and by
    :func:`read_mat`).
    """
    hdr, samples = iqpacket.read_iq(iq_path)
    data = _reference_mat_vars(hdr)
    if normalize:
        data["iq"] = iqpacket.to_complex(np.asarray(samples), hdr.bit_width)
    else:
        data["iq"] = np.asarray(samples).T  # 2 x N like the MATLAB fread
    if v73:
        _save_mat73(mat_path, data)
    else:
        from scipy.io import savemat

        savemat(mat_path, data)
    return hdr


def _reference_mat_vars(hdr: iqpacket.IqHeader) -> dict:
    """The exact variable set ``convert_my_iq_to_mat.m:118`` saves."""
    v = header_vars(hdr)
    return {
        "fs": v["fs"], "fc": v["fc"],
        "dur": (v["numSamples"] / v["fs"]) if v["fs"] else 0.0,
        "bw": v["bw"], "gain": v["gain"], "bitWidth": v["bitWidth"],
        "sampleStartTime": v["sampleStartTime"], "linkSpeed": v["linkSpeed"],
        "boardName": v["boardName"], "serialNo": v["serialNumber"],
        "fpgaVersion": v["fpgaVersion"], "fwVersion": v["fwVersion"],
    }


def _save_mat73(path, data: dict) -> None:
    """Write a MATLAB v7.3 (HDF5) ``.mat``: 512-byte MAT prologue userblock
    + one root dataset per variable with the ``MATLAB_class`` attribute
    (numeric arrays transposed — MATLAB is column-major over HDF5)."""
    import h5py

    with h5py.File(os.fspath(path), "w", userblock_size=512) as f:
        for name, val in data.items():
            if isinstance(val, str):
                # MATLAB char array: uint16 code units, column vector.
                codes = np.array([[ord(c)] for c in val or "\0"], np.uint16)
                ds = f.create_dataset(name, data=codes)
                ds.attrs["MATLAB_class"] = np.bytes_(b"char")
                ds.attrs["MATLAB_int_decode"] = np.int32(2)
                continue
            arr = np.atleast_2d(np.asarray(val))
            if np.iscomplexobj(arr):
                comp = np.empty(arr.T.shape,
                                dtype=[("real", "<f8"), ("imag", "<f8")])
                comp["real"] = arr.T.real
                comp["imag"] = arr.T.imag
                ds = f.create_dataset(name, data=comp)
                ds.attrs["MATLAB_class"] = np.bytes_(b"double")
                continue
            mat_cls = {np.dtype(np.int8): b"int8",
                       np.dtype(np.int16): b"int16",
                       np.dtype(np.int32): b"int32"}.get(
                           arr.dtype, b"double")
            if mat_cls == b"double":
                arr = arr.astype(np.float64)
            ds = f.create_dataset(name, data=arr.T)
            ds.attrs["MATLAB_class"] = np.bytes_(mat_cls)
    head = (b"MATLAB 7.3 MAT-file, written by sdr_channelizer_tpu; "
            b"HDF5 schema 1.00 .")
    # uint16 version 0x0200 little-endian + "IM" endian tag at offset 124
    # (matches MATLAB's own prologue; scipy decodes it as v7.3).
    block = head.ljust(116, b" ") + b"\x00" * 8 + b"\x00\x02IM"
    block = block.ljust(512, b"\x00")
    with open(os.fspath(path), "r+b") as fh:
        fh.write(block)


def _mat73_vars(path) -> dict:
    """Root variables of a v7.3 (HDF5) ``.mat`` as numpy values."""
    import h5py

    out = {}
    with h5py.File(os.fspath(path), "r") as f:
        for name, ds in f.items():
            if name.startswith("#") or not isinstance(ds, h5py.Dataset):
                continue
            val = ds[()]
            cls = ds.attrs.get("MATLAB_class", b"")
            cls = cls.decode() if isinstance(cls, bytes) else str(cls)
            if cls == "char":
                out[name] = "".join(
                    map(chr, np.asarray(val, np.uint16).ravel())).rstrip("\0")
                continue
            val = np.asarray(val)
            if val.dtype.names and {"real", "imag"} <= set(val.dtype.names):
                val = val["real"] + 1j * val["imag"]
            out[name] = val.T  # undo MATLAB's column-major transpose
    return out


def _mat_vars(p: str) -> dict:
    """The variables of a ``.mat``: v5 through scipy, v7.3 (HDF5) through
    h5py."""
    try:
        from scipy.io import loadmat

        z = loadmat(p, squeeze_me=True)
        return {k: v for k, v in z.items() if not k.startswith("__")}
    except NotImplementedError:  # scipy rejects v7.3: HDF5 container
        return _mat73_vars(p)


def _mat_meta(vars_: dict) -> dict:
    """:func:`read_mat`'s metadata: keys under the :func:`header_vars` names
    (``serialNo`` -> ``serialNumber``), one-element arrays as scalars."""
    meta = {}
    for k, v in vars_.items():
        k = {"serialNo": "serialNumber"}.get(k, k)
        if isinstance(v, np.ndarray) and v.dtype.kind in "US":
            v = "" if v.size == 0 else str(v.ravel()[0])
        elif isinstance(v, np.ndarray) and v.ndim == 0:
            v = v.item()
        elif isinstance(v, np.ndarray) and v.size == 1:
            v = v.ravel()[0].item()
        meta[k] = v
    return meta


def _pairs(iq: np.ndarray) -> np.ndarray:
    """A ``.mat``'s integer ``iq`` as (N, 2) pairs: the (2, N) MATLAB
    ``fread`` layout, (N, 2), or interleaved 1-D."""
    if iq.ndim == 2 and iq.shape[0] == 2:
        return np.ascontiguousarray(iq.T)
    if iq.ndim == 2:
        return np.ascontiguousarray(iq)
    return iq.reshape(-1, 2)


def _mat_iq(iq: np.ndarray, meta: dict) -> np.ndarray:
    """A ``.mat``'s ``iq`` as complex64, normalised to [-1, 1) where it is
    the raw integer layout."""
    if np.iscomplexobj(iq):
        return np.asarray(iq, np.complex64).ravel()
    return iqpacket.to_complex(_pairs(iq), int(meta.get("bitWidth", 16)))


def _read_mat_vars(p: str) -> Tuple[np.ndarray, dict]:
    """One parse of a ``.mat``: its ``iq`` (squeezed) and :func:`read_mat`'s
    metadata."""
    vars_ = _mat_vars(p)
    if "iq" not in vars_:
        raise ValueError(f"{p!r} has no 'iq' variable")
    iq = np.squeeze(np.asarray(vars_.pop("iq")))
    return iq, _mat_meta(vars_)


def read_mat(path) -> Tuple[np.ndarray, dict]:
    """Read a capture ``.mat`` (v5 via scipy or v7.3/HDF5 via h5py) ->
    ``(complex64 iq normalized to [-1, 1), metadata)``.

    Accepts both layouts the reference tooling produces: the converter's
    raw (2, N) integer ``iq`` + ``bitWidth`` (``convert_my_iq_to_mat.m:118``,
    normalized here exactly like ``plot_my_iq.m:104-108``) and an
    already-normalized complex ``iq``.  Metadata keys are normalized to the
    :func:`header_vars` names (``serialNo`` -> ``serialNumber``).
    """
    iq, meta = _read_mat_vars(os.fspath(path))
    return _mat_iq(iq, meta), meta


def read_mat_raw(path) -> Tuple[Optional[np.ndarray], int, Optional[dict]]:
    """Raw-payload variant of :func:`read_mat`: ``(samples (N, 2) int,
    bit_width, meta)`` when the ``.mat`` holds the reference's raw integer
    layout, else ``(None, 0, None)`` (complex ``iq`` has lost the bits)."""
    vars_ = _mat_vars(os.fspath(path))
    iq = np.squeeze(np.asarray(vars_.get("iq")))
    if iq is None or np.iscomplexobj(iq) or iq.dtype.kind != "i":
        return None, 0, None
    meta = {("serialNumber" if k == "serialNo" else k):
            (v.item() if isinstance(v, np.ndarray) and v.size == 1 else v)
            for k, v in vars_.items() if k != "iq"}
    return _pairs(iq), int(meta.get("bitWidth", 16)), meta


_LEGACY_RE = re.compile(r"^(\d+)M_(\d+)_MHz_(\d+)\.bin$")


def read_legacy_bin(path) -> Tuple[np.ndarray, float, float, int]:
    """Read a legacy headerless capture: interleaved float32 I/Q with
    ``"<rateM>M_<fcMHz>_MHz_<index>.bin"`` filename metadata.

    Returns ``(iq complex64, fs, fc, index)``.
    """
    name = os.path.basename(os.fspath(path))
    m = _LEGACY_RE.match(name)
    if not m:
        raise ValueError(
            f"legacy filename {name!r} does not match '<rate>M_<fc>_MHz_<n>.bin'"
        )
    fs = float(m.group(1)) * 1e6
    fc = float(m.group(2)) * 1e6
    idx = int(m.group(3))
    raw = np.fromfile(os.fspath(path), dtype="<f4")
    if raw.size % 2:
        raw = raw[:-1]
    iq = raw[0::2] + 1j * raw[1::2]
    return iq.astype(np.complex64), fs, fc, idx


def load_capture(path) -> Tuple[np.ndarray, dict]:
    """Load any supported capture container -> (complex64 iq, metadata).

    Accepts ``.iq`` (versioned binary), ``.npz`` (converted), ``.mat``
    (v5 or v7.3 — the reference's own converted captures,
    ``convert_my_iq_to_mat.m:118`` / ``plot_my_iq.m:93-99``), or legacy
    ``.bin`` — every ingest path of the reference scripts.
    """
    p = os.fspath(path)
    if p.endswith(".mat"):
        return read_mat(p)
    if p.endswith(".iq"):
        hdr, samples = iqpacket.read_iq(p)
        iq = iqpacket.to_complex(np.asarray(samples), hdr.bit_width)
        return iq, header_vars(hdr)
    if p.endswith(".npz"):
        z = np.load(p, allow_pickle=False)
        meta = {k: z[k].item() if z[k].ndim == 0 else z[k] for k in z.files
                if k not in ("iq", "iq_raw")}
        if "iq" in z.files:
            return np.asarray(z["iq"], np.complex64), meta
        raw = z["iq_raw"]
        return iqpacket.to_complex(raw, int(meta["bitWidth"])), meta
    if p.endswith(".bin"):
        iq, fs, fc, idx = read_legacy_bin(p)
        return iq, {"fs": fs, "fc": fc, "index": idx, "bitWidth": 32,
                    "sampleStartTime": 0.0}
    raise ValueError(f"unsupported capture container: {p}")


def load_capture_raw(path) -> Tuple[Optional[np.ndarray], int, Optional[dict]]:
    """Like :func:`load_capture` but returns the raw integer payload when
    the container has one: ``(samples (N, 2) int8/int16, bit_width,
    metadata)``, or ``(None, 0, None)`` for float containers.

    The raw payload feeds the packed-ingest fused pipeline
    (``models.ChannelizerPipeline.extract_fused``) — the on-disk bytes go
    to the device untouched and the dequant happens in-kernel, which
    halves/quarters the host->device traffic of the complex path.
    """
    p = os.fspath(path)
    if p.endswith(".mat"):
        return read_mat_raw(p)
    if p.endswith(".iq"):
        hdr, samples = iqpacket.read_iq(p)
        return np.asarray(samples), hdr.bit_width, header_vars(hdr)
    if p.endswith(".npz"):
        z = np.load(p, allow_pickle=False)
        if "iq_raw" in z.files:
            meta = {k: z[k].item() if z[k].ndim == 0 else z[k]
                    for k in z.files if k not in ("iq", "iq_raw")}
            return np.asarray(z["iq_raw"]), int(meta["bitWidth"]), meta
    return None, 0, None


def load_capture_payload(
    path,
) -> Tuple[Optional[np.ndarray], int, Optional[np.ndarray], dict]:
    """One read of any capture container -> ``(raw, bit_width, iq, meta)``:
    the raw integer pairs and their bit width where the container holds
    them (``iq`` None), else the complex64 samples (``raw`` None, bit width
    0).  What a command that takes either payload reads, so that a float
    ``.mat`` is parsed once, not by :func:`load_capture_raw` and then
    :func:`load_capture`."""
    p = os.fspath(path)
    if p.endswith(".mat"):
        iq, meta = _read_mat_vars(p)
        if not np.iscomplexobj(iq) and iq.dtype.kind == "i":
            return _pairs(iq), int(meta.get("bitWidth", 16)), None, meta
        return None, 0, _mat_iq(iq, meta), meta
    raw, bit_width, meta = load_capture_raw(p)
    if raw is not None:
        return raw, bit_width, None, meta
    iq, meta = load_capture(p)
    return None, 0, iq, meta
