"""The port's capture tier against the JAX package: the host emulator's
dwells bit for bit, the gain search step for step, the closed-loop tracker
dwell for dwell (pulse counts, saturation and gain exactly wherever the two
loops scheduled the same start sample; event times within a float32 fit's
reach), the device emitter held to the radio's physics on the CPU, and the
``record`` / ``gain-search`` / ``predict`` / ``track`` commands."""

import math
import os

import numpy as np
import pytest
import torch

from sdr_channelizer_tpu.capture import EmulatedRadio as JRadio
from sdr_channelizer_tpu.capture import EventTracker as JTracker
from sdr_channelizer_tpu.capture import find_max_unsaturated_gain as j_search
from sdr_channelizer_tpu.capture.hardware import DwellError as JDwellError
from sdr_channelizer_tpu.cli.main import main as jmain
from sdr_channelizer_tpu.io import iqpacket as jiq
from sdr_channelizer_tpu.io.convert import load_capture as j_load_capture
from sdr_channelizer_tpu_torch.capture import (
    DeviceDwellEmitter,
    DwellError,
    EmulatedRadio,
    EventTracker,
    find_max_unsaturated_gain,
)
from sdr_channelizer_tpu_torch.cli.main import main
from sdr_channelizer_tpu_torch.config import CaptureConfig
from sdr_channelizer_tpu_torch.io import iqpacket as tiq
from sdr_channelizer_tpu_torch.io.convert import load_capture as t_load_capture

torch.set_num_threads(1)

# the scene of tests/test_capture.py: a scanning beam at 1 Msps, 0.2 % duty
SCENE = dict(sample_rate_sps=1e6, tone_offset_hz=0.1e6, pulse_width_sec=10e-6,
             pri_sec=5e-3, gain_db=60.0, rel_amplitude=0.9, noise_db=-55.0,
             scan_period_sec=0.5, scan_phase_sec=0.1,
             scan_curvature_db_per_s2=2000.0)
# A float32 fit on TOAs relative to the dwell (seconds): both packages fit in
# float32 with sums in another order, and the event is an extremum of a
# noisy parabola, so a last-place difference in a moment moves it by far
# less than one sample (1e-6 s) of the 1 Msps scene.
EVENT_ATOL_S = 1e-6


def test_capture_config_is_the_jax_config():
    from sdr_channelizer_tpu.config import CaptureConfig as JCaptureConfig

    kw = dict(frequency_mhz=100, bandwidth_mhz=8, sample_rate_msps=2,
              rx_gain_db=60, dwell_sec=0.01, duration_sec=0.03)
    assert CaptureConfig(**kw).dwell_samples == JCaptureConfig(**kw).dwell_samples


@pytest.mark.parametrize("kw", [
    SCENE,
    dict(sample_rate_sps=2e6, tone_offset_hz=0.31e6, pulse_width_sec=100e-6,
         pri_sec=2e-3, gain_db=66.0, noise_db=-55.0, start_epoch=1.7e9,
         bit_width=8),
    dict(sample_rate_sps=1e6, rel_amplitude=0.0, seed=9),
])
def test_emulated_radio_is_the_jax_radio_bit_for_bit(kw):
    t, j = EmulatedRadio(**kw), JRadio(**kw)
    start = kw.get("start_epoch", 0.0)
    for n, st in ((20_000, None), (5_000, start + 0.1), (7_777, None),
                  (3_000, start + 0.05)):          # a start in the past
        (a, ta), (b, tb) = t.receive(n, start_time=st), j.receive(n, start_time=st)
        assert a.dtype == b.dtype == np.complex64 and ta == tb
        np.testing.assert_array_equal(a, b)
    assert t.counters.values == j.counters.values


@pytest.mark.parametrize("gain, noise_db", [(64.0, -300.0), (66.0, -55.0),
                                            (50.0, -60.0)])
def test_gain_search_is_the_jax_search(gain, noise_db):
    kw = dict(sample_rate_sps=1e6, tone_offset_hz=0.13e6, gain_db=gain,
              noise_db=noise_db)
    got = find_max_unsaturated_gain(EmulatedRadio(**kw), 2000, 10)
    ref = j_search(JRadio(**kw), 2000, 10)
    assert got == ref


class _Flaky:
    """A radio whose second dwell fails with ``error``."""

    def __init__(self, inner, error):
        self.inner, self.error, self.calls = inner, error, 0
        self.sample_rate_sps = inner.sample_rate_sps

    @property
    def gain_db(self):
        return self.inner.gain_db

    @gain_db.setter
    def gain_db(self, v):
        self.inner.gain_db = v

    def receive(self, n, start_time=None):
        self.calls += 1
        if self.calls == 2:
            raise self.error("timeout", f"ERROR_CODE_TIMEOUT: 0/{n}")
        return self.inner.receive(n, start_time=start_time)


def test_gain_search_survives_errored_dwells():
    kw = dict(sample_rate_sps=1e6, gain_db=64.0, noise_db=-300.0)
    from sdr_channelizer_tpu_torch.utils.metrics import Counters

    c = Counters()
    got = find_max_unsaturated_gain(_Flaky(EmulatedRadio(**kw), DwellError),
                                    2000, 6, counters=c)
    ref = j_search(_Flaky(JRadio(**kw), JDwellError), 2000, 6)
    assert got == ref and c.get("dwell_errors_timeout") == 1


@pytest.fixture(scope="module")
def tracked():
    """Both trackers over the same scene, 12 dwells of 80 ms."""
    t = EventTracker(radio=EmulatedRadio(**SCENE), dwell_sec=0.08,
                     device="cpu")
    j = JTracker(radio=JRadio(**SCENE), dwell_sec=0.08)
    return t, t.run(12), j, j.run(12)


def test_tracker_matches_jax_dwell_for_dwell(tracked):
    t, got, j, ref = tracked
    matched = 0
    for a, b in zip(got, ref):
        if round(a.start_time * 1e6) != round(b.start_time * 1e6):
            continue      # the schedules parted: a different dwell
        matched += 1
        assert (a.num_pulses, a.saturated, a.gain_db) == \
            (b.num_pulses, b.saturated, b.gain_db)
        assert (a.event_time is None) == (b.event_time is None)
        if a.event_time is not None:
            assert abs(a.event_time - b.event_time) <= EVENT_ATOL_S
    assert matched == 12
    assert sum(r.event_time is not None for r in got) >= 3
    assert t.counters.values == j.counters.values


def test_tracker_recovers_scan_period(tracked):
    t, reports, _, _ = tracked
    ev = np.asarray(t.events)
    err = np.abs(((ev - 0.1 + 0.25) % 0.5) - 0.25)
    assert len(ev) >= 3 and np.median(err) < 0.02, ev


def test_tracker_schedules_from_enough_events():
    """Past ``min_events_for_pri`` events the next dwell starts at
    ``next_event - dwell / 2``, as in the JAX package."""
    t = EventTracker(radio=EmulatedRadio(**SCENE), dwell_sec=0.08,
                     device="cpu")
    j = JTracker(radio=JRadio(**SCENE), dwell_sec=0.08)
    got, ref = t.run(40), j.run(40)
    assert t.next_event_time is not None
    assert abs(t.next_event_time - j.next_event_time) <= 10 * EVENT_ATOL_S
    for prev, cur in zip(got, got[1:]):
        if prev.next_event_time is not None:
            assert abs(cur.start_time - (prev.next_event_time - 0.04)) < 2e-6
    assert [r.num_pulses for r in got][:20] == [r.num_pulses for r in ref][:20]


def test_tracker_drops_errored_dwells_as_jax_does():
    kw = dict(sample_rate_sps=1e6, tone_offset_hz=0.13e6,
              pulse_width_sec=10e-6, pri_sec=5e-3, gain_db=60.0,
              rel_amplitude=0.9, noise_db=-55.0)
    t = EventTracker(radio=_Flaky(EmulatedRadio(**kw), DwellError),
                     dwell_sec=0.02, device="cpu")
    j = JTracker(radio=_Flaky(JRadio(**kw), JDwellError), dwell_sec=0.02)
    got, ref = t.run(4), j.run(4)
    assert [r.num_pulses for r in got] == [r.num_pulses for r in ref]
    # an unscheduled errored dwell reports a NaN start, as the reference
    assert math.isnan(got[1].start_time) and math.isnan(ref[1].start_time)
    assert t.counters.values == j.counters.values
    assert t.counters.get("dwell_errors_timeout") == 1


def test_device_emitter_matches_radio_physics():
    """The device emitter reproduces the radio's signal model (duty cycle,
    amplitude, scan envelope), its timed dwells, and drives the tracker
    closed loop; here on the CPU, on the card in ``chip_smoke.py``."""
    kw = {**SCENE, "tone_offset_hz": 0.13e6}
    dev = DeviceDwellEmitter(**kw, device="cpu")
    host = EmulatedRadio(**kw)
    (xr, xi), t0 = dev.receive(80000, start_time=0.06)
    iq_h, t0_h = host.receive(80000, start_time=0.06)
    assert t0 == t0_h and xr.dtype == torch.float32 and xr.shape == (80000,)
    mag_d = torch.hypot(xr, xi).numpy()
    mag_h = np.abs(iq_h)
    on_d, on_h = mag_d > 0.05, mag_h > 0.05
    assert abs(on_d.mean() - on_h.mean()) < 1e-3  # same duty cycle
    np.testing.assert_allclose(mag_d[on_d].max(), mag_h[on_h].max(), rtol=0.05)
    np.testing.assert_array_equal(on_d, on_h)      # the same pulse samples
    # quantised to the ADC grid, clipped at full scale
    q = xr.numpy() * 2048
    assert np.array_equal(q, np.round(q)) and q.max() <= 2047
    dev.receive(1000, start_time=1.0)
    assert dev.counters.get("samples_skipped") > 0
    # the same seed gives the same dwells; another seed other noise
    a = DeviceDwellEmitter(**kw, device="cpu").receive(4000)[0][0]
    b = DeviceDwellEmitter(**kw, device="cpu").receive(4000)[0][0]
    c = DeviceDwellEmitter(**kw, seed=7, device="cpu").receive(4000)[0][0]
    assert torch.equal(a, b) and not torch.equal(a, c)

    tr = EventTracker(radio=DeviceDwellEmitter(**kw, device="cpu"),
                      dwell_sec=0.08, device="cpu")
    reports = tr.run(12)
    assert sum(r.num_pulses for r in reports) > 0
    assert len(tr.events) > 0


def test_device_emitter_second_emitter_and_saturation():
    kw = {**SCENE, "tone_offset_hz": 0.13e6}
    two = DeviceDwellEmitter(**kw, tone2_offset_hz=-0.09e6,
                             pulse_width2_sec=15e-6, pri2_sec=3.3e-3,
                             rel_amplitude2=0.2, device="cpu")
    (xr, xi), _ = two.receive(100000, start_time=0.06)
    mag = torch.hypot(xr, xi).numpy()
    n_edges = int(np.sum((mag[1:] > 0.05) & (mag[:-1] <= 0.05)))
    assert abs(n_edges - (0.1 / 5e-3 + 0.1 / 3.3e-3)) <= 3, n_edges
    sat = DeviceDwellEmitter(**{**kw, "rel_amplitude": 2.0}, device="cpu")
    tr = EventTracker(radio=sat, dwell_sec=0.08, device="cpu")
    tr.run(14)
    assert tr.counters.get("saturation_events") > 0 and sat.gain_db < 60.0


# --------------------------------------------------------------- the CLI

REC = ["1000", "8", "1", "60", "0.08", "0.24", "--offset-mhz", "0.1",
       "--pw-us", "10", "--pri-us", "5000", "--noise-db", "-55",
       "--python-emulator"]


def _record(fn, out_dir, capsys):
    assert fn(["record", *REC, "--out-dir", str(out_dir)]) == 0
    return capsys.readouterr().out.split()


def test_cli_record_writes_the_jax_recorders_dwells(tmp_path, capsys):
    got = _record(main, tmp_path / "t", capsys)
    ref = _record(jmain, tmp_path / "j", capsys)
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        (ha, sa), (hb, sb) = tiq.read_iq(a), jiq.read_iq(b)
        np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))
        assert ha.num_samples == hb.num_samples == 80000
        assert ha.board_name == hb.board_name == "emulated-py"
        # and load_capture reads them as the JAX package's does
        (ia, ma), (ib, mb) = t_load_capture(a), j_load_capture(b)
        assert ia.dtype == ib.dtype == np.complex64
        np.testing.assert_array_equal(ia, ib)
        assert ma.keys() == mb.keys() and ma["fs"] == mb["fs"] == 1e6
    # the start times continue from file to file
    t0 = [tiq.read_iq(p)[0].sample_start_time for p in got]
    np.testing.assert_allclose(np.diff(t0), 0.08, atol=1e-6)


def test_cli_gain_search_prints_the_jax_lines(capsys):
    argv = ["gain-search", "1000", "8", "1", "64", "0.002", "0.02",
            "--offset-mhz", "0.13", "--noise-db", "-300"]
    assert main(argv) == 0
    got = capsys.readouterr().out
    assert jmain(argv) == 0
    assert got == capsys.readouterr().out
    assert "Max unsaturated gain: 59.0 dB" in got


def _event_lines(out):
    """``{file name: (event, next)}`` from ``predict``'s lines."""
    res = {}
    for line in out.splitlines():
        if ": event at +" in line:
            path, rest = line.split(": event at +")
            ev, nxt = rest.split("s, next predicted +")
            res[os.path.basename(path)] = (float(ev), float(nxt.rstrip("s")))
    return res


def test_cli_predict_matches_jax_predict(tmp_path, capsys):
    """Three dwells of a full-scale scanning beam peaking at 0.06 s (two
    clear the amplitude gate), written by the port's recorder, then
    ``predict`` in both packages."""
    from sdr_channelizer_tpu_torch.cli.main import record_dwells

    cfg = CaptureConfig(frequency_mhz=1000, bandwidth_mhz=8,
                        sample_rate_msps=1, rx_gain_db=60, dwell_sec=0.08,
                        duration_sec=0.24)
    os.makedirs(tmp_path / "d")
    scene = {**SCENE, "rel_amplitude": 1.0, "scan_phase_sec": 0.06}
    files = record_dwells(EmulatedRadio(**scene, start_epoch=100.0), cfg,
                          str(tmp_path / "d"))
    argv = ["predict", *files, "--max-pulses", "32"]
    assert main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jmain(argv) == 0
    ref = capsys.readouterr().out
    g, r = _event_lines(got), _event_lines(ref)
    assert len(g) == len(r) >= 2 and g.keys() == r.keys()
    for k in g:
        np.testing.assert_allclose(g[k], r[k], rtol=0, atol=2e-6)
    assert abs(g[os.path.basename(files[0])][0] - 0.06) < 0.02
    png = tmp_path / "f.png"
    assert main(argv + ["--device", "cpu", "--png", str(png)]) == 0
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert capsys.readouterr().out == got


def test_cli_track_matches_jax_track(capsys):
    argv = ["track", "1000", "8", "1", "60", "0.08", "0.96",
            "--offset-mhz", "0.1", "--pw-us", "10", "--pri-us", "5000",
            "--noise-db", "-55", "--amplitude", "0.9"]
    assert main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert jmain(argv) == 0
    ref = capsys.readouterr().out.splitlines()
    assert len(got) == len(ref) == 12
    assert [line.split("event")[0] for line in got] == \
        [line.split("event")[0] for line in ref]
    assert sum("event=" in line for line in got) >= 3
