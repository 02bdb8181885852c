"""Capture loading for the port: ``.iq`` containers only so far (the
``.npz``, ``.mat`` and ``.bin`` readers are not ported yet)."""

from __future__ import annotations

import os
from typing import Tuple

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


def _iq_only(path) -> str:
    p = os.fspath(path)
    if not p.endswith(".iq"):
        raise NotImplementedError(
            f"not ported yet: only .iq captures are supported, got {p!r}")
    return p


def load_capture(path) -> Tuple[np.ndarray, dict]:
    """``.iq`` file -> ``(complex64 iq, metadata)``: the samples normalised
    by the bit width, the header under the reference's variable names
    (``fs``, ``fc``, ``sampleStartTime``, ...)."""
    hdr, samples = iqpacket.read_iq(_iq_only(path))
    return iqpacket.to_complex(np.asarray(samples), hdr.bit_width), \
        header_vars(hdr)


def load_capture_raw(path) -> Tuple[np.ndarray, int, dict]:
    """``.iq`` file -> ``(samples (N, 2) int8/int16, bit_width, metadata)``.

    The raw payload feeds the packed-ingest pipeline
    (``models.ChannelizerPipeline.extract_fused``): the on-disk bytes go to
    the device untouched and the dequantization happens in the kernel.
    Other containers (``.npz``, ``.mat``, ``.bin``) are not ported yet.
    """
    hdr, samples = iqpacket.read_iq(_iq_only(path))
    return np.asarray(samples), hdr.bit_width, header_vars(hdr)
