"""The port's radio backends against the JAX package's: one set of driver
doubles (``tests/test_hardware_seam.py``'s classes, each module double built
with the package's own ``vendor_api.strict_namespace``) drives both
packages' ``UhdRadio`` and ``BladeRadio``; they must make the same driver
calls in the same order, return the same samples and timestamps, raise the
same ``DwellError`` codes and converge in the same gain search.  Also the
declared surfaces name for name, the AST scan of the port's ``hardware.py``
and the provisioning commands."""

import ast
import inspect
import types

import numpy as np
import pytest

from sdr_channelizer_tpu.capture import hardware as jhw
from sdr_channelizer_tpu.capture import vendor_api as japi
from sdr_channelizer_tpu.capture.gain_search import (
    find_max_unsaturated_gain as j_search,
)
from sdr_channelizer_tpu.cli.main import main as jmain
from sdr_channelizer_tpu_torch.capture import EmulatedRadio, EventTracker
from sdr_channelizer_tpu_torch.capture import hardware as thw
from sdr_channelizer_tpu_torch.capture import vendor_api as tapi
from sdr_channelizer_tpu_torch.capture.gain_search import (
    find_max_unsaturated_gain as t_search,
)
from sdr_channelizer_tpu_torch.cli.main import main
from test_hardware_seam import (
    _FakeBlade,
    _FakeBladeStock,
    _FakeMultiUSRP,
    _FakeRxStream,
    _TimeSpec,
)

PACKAGES = {"port": (thw, tapi), "jax": (jhw, japi)}
SURFACES = ["UHD_MODULE", "UHD_MULTI_USRP", "UHD_RX_STREAMER",
            "UHD_STREAM_CMD_FIELDS", "UHD_RX_METADATA_FIELDS",
            "UHD_PROPERTY_TREE", "BLADERF_MODULE", "BLADERF_DEVICE",
            "BLADERF_METADATA_FIELDS"]
RADIO = dict(frequency_hz=1e9, sample_rate_sps=1e6, bandwidth_hz=0.8e6,
             gain_db=66.0)


@pytest.fixture(autouse=True)
def frozen_clock(monkeypatch):
    """The radios read the host clock for their schedules and stamps."""
    monkeypatch.setattr("time.sleep", lambda s: None)
    monkeypatch.setattr("time.time", lambda: 1723800000.0)


def fake_uhd(api, log):
    class StreamCMD:
        def __init__(self, mode):
            self.mode = mode

    return api.strict_namespace(
        api.UHD_MODULE,
        usrp=api.strict_namespace(
            api.UHD_MODULE,
            MultiUSRP=lambda args: _FakeMultiUSRP(log),
            StreamArgs=lambda cpu, otw: types.SimpleNamespace(cpu=cpu, otw=otw),
            SubdevSpec=lambda s: types.SimpleNamespace(spec=s),
        ),
        types=api.strict_namespace(
            api.UHD_MODULE,
            TimeSpec=_TimeSpec,
            TuneRequest=lambda f: types.SimpleNamespace(target=f),
            StreamCMD=StreamCMD,
            StreamMode=api.strict_namespace(api.UHD_MODULE,
                                            num_done="num_done"),
            RXMetadata=lambda: types.SimpleNamespace(time_spec=None,
                                                     error_code=0),
        ),
    )


def fake_bladerf(api, log, stock=False):
    class Metadata:
        def __init__(self):
            self.flags = 0
            self.timestamp = 0
            self.status = 0

    common = dict(
        CHANNEL_RX=lambda i: ("rx", i),
        GainMode=api.strict_namespace(api.BLADERF_MODULE, Manual="manual"),
        Format=api.strict_namespace(
            api.BLADERF_MODULE, SC16_Q11_META="sc16q11m",
            SC8_Q7_META="sc8q7m", SC16_Q11="sc16q11", SC8_Q7="sc8q7"),
        ChannelLayout=api.strict_namespace(api.BLADERF_MODULE,
                                           RX_X1="rx_x1"),
    )
    if stock:
        return api.strict_namespace(
            api.BLADERF_MODULE, BladeRF=lambda: _FakeBladeStock(log),
            **common)
    return api.strict_namespace(
        api.BLADERF_MODULE, BladeRF=lambda: _FakeBlade(log),
        Metadata=Metadata, META_FLAG_RX_NOW=1, META_STATUS_OVERRUN=2,
        RX="rx", **common)


@pytest.mark.parametrize("name", SURFACES)
def test_declared_surfaces_are_the_jax_ones(name):
    assert getattr(tapi, name) == getattr(japi, name)


def test_all_declared_names_and_strict_doubles():
    assert tapi.all_declared_names() == japi.all_declared_names()
    for cls, surface in ((_FakeMultiUSRP, "UHD_MULTI_USRP"),
                         (_FakeRxStream, "UHD_RX_STREAMER"),
                         (_FakeBlade, "BLADERF_DEVICE"),
                         (_FakeBladeStock, "BLADERF_DEVICE")):
        tapi.strict_object(getattr(tapi, surface), cls)

    class Rogue:
        def set_rx_lo(self):
            pass

    with pytest.raises(KeyError, match="set_rx_lo"):
        tapi.strict_object(tapi.UHD_MULTI_USRP, Rogue)
    with pytest.raises(KeyError, match="MakeUSRP"):
        tapi.strict_namespace(tapi.UHD_MODULE, MakeUSRP=None)


@pytest.mark.parametrize("bit_width", [12, 8])
def test_uhd_radio_is_the_jax_radio(bit_width):
    out = {}
    for name, (hw, api) in PACKAGES.items():
        log = []
        radio = hw.UhdRadio(bit_width=bit_width, driver=fake_uhd(api, log),
                            **RADIO)
        iq, t0 = radio.receive(5000)
        iq2, t1 = radio.receive(3000, start_time=1723800001.0)
        radio.gain_db = 50.0
        out[name] = (log, radio.board_name, radio.serial_number,
                     radio.fpga_version, radio.gain_db, iq, t0, iq2, t1)
    got, ref = out["port"], out["jax"]
    assert isinstance(thw.UhdRadio(driver=fake_uhd(tapi, []), **RADIO),
                      thw.Receiver)
    assert got[:5] == ref[:5]
    assert [e[0] for e in got[0]][:13] == [
        "clock_source", "subdev", "time_now", "stream_args", "rate",
        "bandwidth", "agc", "gain", "antenna", "clear_command_time",
        "command_time", "freq", "clear_command_time"]
    for g, r in zip(got[5:], ref[5:]):
        np.testing.assert_array_equal(g, r)
    assert got[6] == 1723800000.1 and got[8] == 1723800001.0


class _ScriptedStream:
    """``recv`` plays back (error_code, fraction received) pairs with the
    numeric ``rx_metadata_t`` values (none 0x0, timeout 0x1, late 0x2,
    overflow 0x8)."""

    def __init__(self, script):
        self.script = list(script)

    def issue_stream_cmd(self, cmd):
        self._t0 = cmd.time_spec.get_real_secs()

    def recv(self, buf, meta, timeout=0.0):
        err, frac = self.script.pop(0)
        n = int(buf.shape[-1] * frac)
        buf[0, :n] = 0.001 + 0j
        meta.time_spec = _TimeSpec(self._t0)
        meta.error_code = err
        if err == 0x2:
            meta.strerror = lambda: "ERROR_CODE_LATE_COMMAND"
        return n


def test_uhd_error_codes_are_the_jax_codes():
    script = [(0x8, 1.0), (0x8, 0.5), (0x1, 0.0), (0x2, 0.25), (0x0, 0.5),
              (0x0, 1.0)]
    out = {}
    for name, (hw, api) in PACKAGES.items():
        radio = hw.UhdRadio(driver=fake_uhd(api, []), **RADIO)
        radio.rx_stream = _ScriptedStream(script)
        seen = []
        for _ in script:
            try:
                iq, _ = radio.receive(1000)
                seen.append(("ok", len(iq)))
            except hw.DwellError as e:
                seen.append((e.code, str(e)))
        out[name] = (seen, radio.overruns, radio.timeouts)
    assert out["port"] == out["jax"]
    assert [s[0] for s in out["port"][0]] == [
        "ok", "overflow", "timeout", "other", "short", "ok"]
    assert out["port"][1:] == (2, 1)


@pytest.mark.parametrize("stock", [False, True])
@pytest.mark.parametrize("bit_width", [12, 8])
def test_blade_radio_is_the_jax_radio(bit_width, stock):
    out = {}
    for name, (hw, api) in PACKAGES.items():
        log = []
        radio = hw.BladeRadio(bit_width=bit_width,
                              driver=fake_bladerf(api, log, stock), **RADIO)
        iq, t0 = radio.receive(5000)
        iq2, t1 = radio.receive(2000, start_time=1723800000.5)
        out[name] = (log, radio.link_speed, radio.board_name, radio.gain_db,
                     radio.overruns, iq, t0, iq2, t1)
    got, ref = out["port"], out["jax"]
    assert got[:5] == ref[:5]
    for g, r in zip(got[5:], ref[5:]):
        np.testing.assert_array_equal(g, r)
    fmt = dict(got[0])["sync_config"]["fmt"]
    assert fmt == {(12, False): "sc16q11m", (8, False): "sc8q7m",
                   (12, True): "sc16q11", (8, True): "sc8q7"}[bit_width, stock]
    assert got[5].dtype == np.complex64 and np.abs(got[5].real).max() <= 1.0


@pytest.mark.parametrize("backend", ["uhd", "blade"])
def test_gain_search_and_tracker_run_unchanged_on_the_radios(backend):
    radios = {}
    for name, (hw, api) in PACKAGES.items():
        if backend == "uhd":
            radios[name] = hw.UhdRadio(driver=fake_uhd(api, []), **RADIO)
        else:
            radios[name] = hw.BladeRadio(driver=fake_bladerf(api, []),
                                         **RADIO)
    got = t_search(radios["port"], 20000, 10)
    ref = j_search(radios["jax"], 20000, 10)
    assert got == ref and got[0] == 59.0
    tracker = EventTracker(radio=radios["port"], dwell_sec=0.05,
                           device="cpu")
    reports = tracker.run(3)
    assert tracker.counters.get("dwells") == 3
    assert all(r.num_pulses > 0 for r in reports)


def test_hardware_py_uses_only_declared_vendor_names():
    """AST-scan the port's hardware.py: every attribute accessed inside the
    radio classes is either declared in capture/vendor_api.py or one of the
    classes' own attributes and stdlib / NumPy names."""
    declared = tapi.all_declared_names()
    non_vendor = {
        "time", "sleep", "empty", "int16", "int8", "float32", "complex64",
        "astype", "call", "append", "dataclass", "ndarray", "setter",
        "driver", "usrp", "dev", "rx_stream", "channel", "frequency_hz",
        "sample_rate_sps", "bandwidth_hz", "gain_db", "bit_width",
        "device_args", "clock_source", "subdev", "antenna", "overruns",
        "board_name", "serial_number", "fpga_version", "fw_version",
        "link_speed", "_gain_db", "_t0_ticks", "_epoch0", "_has_meta",
        "real", "imag", "timeouts", "code",
    }
    tree = ast.parse(inspect.getsource(thw))
    seen = set()
    for cls in ast.walk(tree):
        if isinstance(cls, ast.ClassDef) and cls.name in ("UhdRadio",
                                                          "BladeRadio"):
            seen |= {n.attr for n in ast.walk(cls)
                     if isinstance(n, ast.Attribute)}
    assert seen and not (seen - declared - non_vendor)


def test_radios_need_their_bindings():
    for cls, lib in ((thw.UhdRadio, "uhd"), (thw.BladeRadio, "bladerf")):
        try:
            __import__(lib)
        except ImportError:
            with pytest.raises(ImportError, match=f"`{lib}`"):
                cls(**RADIO)
    assert isinstance(EmulatedRadio(), thw.Receiver)


@pytest.mark.parametrize("board,workarea", [("A5", "~/workarea"),
                                            ("A9", "/srv/fpga")])
def test_provision_commands_are_the_jax_commands(board, workarea):
    got = thw.provision_bladerf_commands(board, workarea)
    assert got == jhw.provision_bladerf_commands(board, workarea)
    assert got[0] == ["bladeRF-cli", "-l",
                      f"{workarea}/hostedx{board}_v0.15.3.rbf"]
    ran = []
    assert thw.provision_bladerf(board, workarea,
                                 runner=lambda c: (ran.append(c), 0)[1]) == 0
    assert ran == got
    assert thw.provision_bladerf(board, runner=lambda c: 3) == 3
    with pytest.raises(ValueError, match="A5 or A9"):
        thw.provision_bladerf_commands("A7")


@pytest.mark.parametrize("board", ["A5", "A9"])
def test_cli_provision_dry_run_prints_the_jax_lines(capsys, board):
    argv = ["provision", board, "--dry-run", "--workarea", "/srv/w"]
    assert main(argv) == 0
    got = capsys.readouterr().out
    assert jmain(argv) == 0
    assert got == capsys.readouterr().out and got.count("bladeRF-cli") == 3
