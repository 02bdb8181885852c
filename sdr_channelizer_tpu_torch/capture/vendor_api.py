"""Single source of truth for the vendor-binding API surfaces the hardware
seam touches.

Every attribute/method of the ``uhd`` and ``bladerf`` Python bindings that
``capture/hardware.py`` calls is declared here, with a citation to where the
name is defined upstream.  Enforcement is two-sided:

* ``tests/test_torch_hardware.py`` builds its driver doubles through
  :func:`strict_namespace` / :func:`strict_object` -- a double cannot define
  a name missing from this spec (construction fails), and a backend cannot
  call a name missing from the double (AttributeError), so neither side can
  drift without editing this reviewed file;
* the same tests AST-scan ``hardware.py`` and assert every vendor attribute
  access is declared here.

The surfaces are the JAX package's, name for name.

Citations (paths into the upstream sources):

* UHD 4.x Python bindings (``pip install uhd`` / built with UHD >= 4.0):
  ``uhd/host/python/uhd/usrp/__init__.py`` re-exports ``MultiUSRP`` (a
  wrapper over ``libpyuhd.usrp.multi_usrp``, whose methods are pybind11
  mirrors of ``uhd::usrp::multi_usrp`` — ``multi_usrp_python.hpp``);
  ``uhd.types`` mirrors ``uhd/types/*`` (``types_python.hpp``:
  ``StreamCMD``, ``StreamMode`` with members ``start_cont/stop_cont/
  num_done/num_more``, ``TimeSpec``, ``TuneRequest``, ``RXMetadata``).
  Manual: files.ettus.com/manual/page_python.html.
* bladeRF Python bindings (``host/libraries/libbladeRF_bindings/python/
  bladerf/_bladerf.py`` in Nuand's tree): class ``BladeRF`` with
  ``get_board_name/get_serial/get_fpga_version/get_fw_version/
  get_device_speed`` (NOT ``get_devinfo_speed`` — the C API is
  ``bladerf_device_speed``), ``set_frequency/get_frequency/
  set_sample_rate/set_bandwidth/set_gain_mode/set_gain/get_gain/
  sync_config/enable_module/sync_rx``; enums ``GainMode`` (``Default/
  Manual/FastAttack_AGC/SlowAttack_AGC/Hybrid_AGC``), ``Format``
  (``SC16_Q11/SC16_Q11_META/SC8_Q7/SC8_Q7_META``), ``ChannelLayout``
  (``RX_X1/TX_X1/RX_X2/TX_X2``); helper ``CHANNEL_RX(ch)``.

KNOWN BINDING GAP (documented, handled at runtime): the official cffi
binding's ``BladeRF.sync_rx(buf, num_samples, timeout_ms=None)`` exposes
neither the metadata struct nor ``bladerf_get_timestamp`` — the reference's
timed dwells and overrun counters (``blade_record_iq_12bit.cpp:289-307``)
need the C API's ``bladerf_sync_rx(..., &meta, ...)``.  ``BladeRadio``
feature-detects ``Metadata`` on the driver module: bindings that expose the
metadata path (e.g. an in-house cffi extension mirroring ``libbladeRF.h``)
get device-timestamped timed dwells; the stock binding falls back to
untimed RX with host-clock timestamps and no overrun detection.
"""

from __future__ import annotations

import types
from typing import Dict, Set

# --- UHD ------------------------------------------------------------------

# Names on the `uhd` module tree itself.
UHD_MODULE: Dict[str, str] = {
    "usrp": "uhd/host/python/uhd/usrp package",
    "types": "uhd/host/python/uhd/types (libpyuhd.types)",
    "MultiUSRP": "uhd.usrp.MultiUSRP — usrp/multi_usrp.py",
    "StreamArgs": "uhd.usrp.StreamArgs(cpu_format, otw_format) — "
                  "stream_python.hpp",
    "SubdevSpec": "uhd.usrp.SubdevSpec(markup) — subdev_spec_python.hpp",
    "TimeSpec": "uhd.types.TimeSpec(real_secs) — types/time_spec_python.hpp",
    "TuneRequest": "uhd.types.TuneRequest(target_freq) — "
                   "types/tune_python.hpp",
    "StreamCMD": "uhd.types.StreamCMD(StreamMode) — types_python.hpp",
    "StreamMode": "uhd.types.StreamMode enum — types_python.hpp",
    "num_done": "StreamMode.num_done (= STREAM_MODE_NUM_SAMPS_AND_DONE)",
    "RXMetadata": "uhd.types.RXMetadata — metadata_python.hpp",
    "RXMetadataErrorCode": "uhd.types.RXMetadataErrorCode enum — "
                           "metadata_python.hpp (rx_metadata_t::error_code_t)",
    "none": "RXMetadataErrorCode.none (= ERROR_CODE_NONE, 0x0)",
    "timeout": "RXMetadataErrorCode.timeout (= ERROR_CODE_TIMEOUT, 0x1)",
    "overflow": "RXMetadataErrorCode.overflow (= ERROR_CODE_OVERFLOW, 0x8)",
}

UHD_MULTI_USRP: Dict[str, str] = {
    "get_mboard_name": "multi_usrp::get_mboard_name",
    "get_usrp_rx_info": "multi_usrp::get_usrp_rx_info -> dict with "
                        "'mboard_serial'",
    "get_tree": "multi_usrp::get_tree (property-tree exposure varies by "
                "UHD version; hardware.py guards it)",
    "set_clock_source": "multi_usrp::set_clock_source",
    "set_rx_subdev_spec": "multi_usrp::set_rx_subdev_spec(SubdevSpec)",
    "set_time_now": "multi_usrp::set_time_now(TimeSpec)",
    "get_time_now": "multi_usrp::get_time_now",
    "get_rx_stream": "multi_usrp::get_rx_stream(StreamArgs)",
    "set_rx_rate": "multi_usrp::set_rx_rate",
    "get_rx_rate": "multi_usrp::get_rx_rate",
    "set_rx_bandwidth": "multi_usrp::set_rx_bandwidth",
    "get_rx_bandwidth": "multi_usrp::get_rx_bandwidth",
    "set_rx_agc": "multi_usrp::set_rx_agc",
    "set_rx_gain": "multi_usrp::set_rx_gain",
    "get_rx_gain": "multi_usrp::get_rx_gain",
    "set_rx_antenna": "multi_usrp::set_rx_antenna",
    "get_rx_antenna": "multi_usrp::get_rx_antenna",
    "clear_command_time": "multi_usrp::clear_command_time",
    "set_command_time": "multi_usrp::set_command_time(TimeSpec)",
    "set_rx_freq": "multi_usrp::set_rx_freq(TuneRequest)",
    "get_rx_freq": "multi_usrp::get_rx_freq",
}

UHD_RX_STREAMER: Dict[str, str] = {
    "issue_stream_cmd": "rx_streamer::issue_stream_cmd(StreamCMD)",
    "recv": "rx_streamer.recv(numpy buffer (chans, samps), RXMetadata, "
            "timeout) -> num received — rx_streamer_python.hpp",
}

UHD_STREAM_CMD_FIELDS: Dict[str, str] = {
    "num_samps": "stream_cmd_t::num_samps",
    "stream_now": "stream_cmd_t::stream_now",
    "time_spec": "stream_cmd_t::time_spec",
}

UHD_RX_METADATA_FIELDS: Dict[str, str] = {
    "time_spec": "rx_metadata_t::time_spec (TimeSpec)",
    "error_code": "rx_metadata_t::error_code",
    "strerror": "rx_metadata_t::strerror (usrp_record_iq_12bit.cpp:216)",
    "get_real_secs": "time_spec_t::get_real_secs",
}

UHD_PROPERTY_TREE: Dict[str, str] = {
    "access_str": "property_tree access for string properties "
                  "(property_tree_python.hpp; exposure varies by version)",
    "get": "property<str>::get",
}

# --- bladeRF ----------------------------------------------------------------

BLADERF_MODULE: Dict[str, str] = {
    "BladeRF": "_bladerf.py class BladeRF (opens first device)",
    "CHANNEL_RX": "_bladerf.py CHANNEL_RX(ch) -> channel id "
                  "(BLADERF_CHANNEL_RX macro)",
    "GainMode": "_bladerf.py enum GainMode",
    "Manual": "GainMode.Manual (= BLADERF_GAIN_MGC)",
    "Format": "_bladerf.py enum Format",
    "SC16_Q11_META": "Format.SC16_Q11_META (= BLADERF_FORMAT_SC16_Q11_META)",
    "SC8_Q7_META": "Format.SC8_Q7_META (= BLADERF_FORMAT_SC8_Q7_META)",
    "SC16_Q11": "Format.SC16_Q11 — the no-metadata fallback format",
    "SC8_Q7": "Format.SC8_Q7 — the no-metadata fallback format",
    "ChannelLayout": "_bladerf.py enum ChannelLayout",
    "RX_X1": "ChannelLayout.RX_X1",
    # Metadata extension surface — NOT in the stock cffi binding (see module
    # docstring); BladeRadio feature-detects it and falls back without it.
    "Metadata": "metadata-capable bindings only: struct bladerf_metadata "
                "(libbladeRF.h)",
    "META_FLAG_RX_NOW": "BLADERF_META_FLAG_RX_NOW (libbladeRF.h)",
    "META_STATUS_OVERRUN": "BLADERF_META_STATUS_OVERRUN (libbladeRF.h)",
    "RX": "direction selector for bladerf_get_timestamp(BLADERF_RX)",
}

BLADERF_DEVICE: Dict[str, str] = {
    "get_device_speed": "BladeRF.get_device_speed -> DeviceSpeed "
                        "(bladerf_device_speed)",
    "get_serial": "BladeRF.get_serial (bladerf_get_serial)",
    "get_board_name": "BladeRF.get_board_name (bladerf_get_board_name)",
    "get_fpga_version": "BladeRF.get_fpga_version (bladerf_fpga_version)",
    "get_fw_version": "BladeRF.get_fw_version (bladerf_fw_version)",
    "set_frequency": "BladeRF.set_frequency(ch, freq)",
    "get_frequency": "BladeRF.get_frequency(ch)",
    "set_sample_rate": "BladeRF.set_sample_rate(ch, rate) -> actual",
    "set_bandwidth": "BladeRF.set_bandwidth(ch, bw) -> actual",
    "set_gain_mode": "BladeRF.set_gain_mode(ch, GainMode)",
    "set_gain": "BladeRF.set_gain(ch, gain_db)",
    "get_gain": "BladeRF.get_gain(ch)",
    "sync_config": "BladeRF.sync_config(layout, fmt, num_buffers, "
                   "buffer_size, num_transfers, stream_timeout)",
    "enable_module": "BladeRF.enable_module(ch, enable)",
    "sync_rx": "stock: BladeRF.sync_rx(buf, num_samples, timeout_ms); "
               "metadata-capable: sync_rx(buf, num_samples, meta, "
               "timeout_ms) mirroring bladerf_sync_rx",
    "get_timestamp": "metadata-capable bindings only: "
                     "bladerf_get_timestamp(dev, dir)",
}

BLADERF_METADATA_FIELDS: Dict[str, str] = {
    "flags": "bladerf_metadata.flags",
    "timestamp": "bladerf_metadata.timestamp",
    "status": "bladerf_metadata.status",
}


def strict_namespace(surface: Dict[str, str], **members):
    """A ``SimpleNamespace`` whose members must all be declared in
    ``surface`` — test doubles built through this cannot invent vendor
    names, and backends calling undeclared names get AttributeError."""
    undeclared = set(members) - set(surface)
    if undeclared:
        raise KeyError(
            f"double defines names missing from the vendor API spec: "
            f"{sorted(undeclared)} — declare them in capture/vendor_api.py "
            f"with a citation first"
        )
    return types.SimpleNamespace(**members)


def strict_object(surface: Dict[str, str], cls: type) -> None:
    """Assert a double class's public members are all declared in
    ``surface`` (call at class-definition time in tests)."""
    public = {n for n in vars(cls) if not n.startswith("_")}
    undeclared = public - set(surface)
    if undeclared:
        raise KeyError(
            f"{cls.__name__} defines names missing from the vendor API "
            f"spec: {sorted(undeclared)} — declare them in "
            f"capture/vendor_api.py with a citation first"
        )


def all_declared_names() -> Set[str]:
    """Every declared vendor attribute name (both drivers, all roles) —
    consumed by the hardware.py AST-scan test."""
    out: Set[str] = set()
    for d in (UHD_MODULE, UHD_MULTI_USRP, UHD_RX_STREAMER,
              UHD_STREAM_CMD_FIELDS, UHD_RX_METADATA_FIELDS,
              UHD_PROPERTY_TREE,
              BLADERF_MODULE, BLADERF_DEVICE, BLADERF_METADATA_FIELDS):
        out |= set(d)
    return out
