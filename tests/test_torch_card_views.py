"""The capture containers, the views and the command line on the card.

The sparse capture (M = 64 x 262144 frames, int16, bit width 12) is
written as ``.iq`` and converted by the CLI to a raw ``.npz``, a raw v5
``.mat``, a normalised ``.npz`` and, with ``h5py``, a raw v7.3 ``.mat``;
each raw payload goes through ``extract_fused`` (K1 once each, PDWs bit
for bit the ``.iq`` run's), the normalised one through ``extract``.
``channelize`` runs B9 once a file, ``waterfall_window_pngs`` once a
window (its renderer replaced by a recorder, so that it runs without
``matplotlib``); the wideband 16M capture at bit width 12 goes packed
through ``stft_power_packed``, held against a float64 STFT and
``stft_power``.  Then the CLI on a synthetic capture: ``pdw`` channelized,
streamed and wideband against the generator's truth, ``record``,
``predict``, ``track``, ``gain-search``, ``convert`` to every container and
``pdw`` on each, ``spectrogram``, ``plot``, ``pdw --png``, ``predict
--png``, ``txrx`` and ``provision --dry-run``.  A case whose optional
library (``matplotlib``, ``h5py``, ``cv2`` or ``ffmpeg``) is missing skips
and says which.

Marked ``card``: skipped without a CUDA card.  No JAX in this file:

    python -m pytest tests/test_torch_card_views.py -q -p no:cacheprovider \\
        -o addopts="" --noconftest -m card
"""

import contextlib
import dataclasses
import io
import os
import shutil

import numpy as np
import pytest
import torch

from sdr_channelizer_tpu_torch import bench
from torch_card_fixtures import (
    BIT_WIDTH, DEVICE, FRAMES_MAIN, M_MAIN, MAG_TOL, SPEC_TOL, WIDE_SAMPLES,
    check, have, max_abs, pack, pdws_agree, pdws_identical, run_cli,
    step_runs, wideband_capture)
from torch_card_fixtures import caps, card, pipe  # noqa: F401  (fixtures)

pytestmark = pytest.mark.card

FS = M_MAIN * 1e6
CONVERSIONS = {"npz_raw": ["--raw"], "mat_raw": ["--mat", "--raw"],
               "npz": [], "mat73_raw": ["--mat", "--v73", "--raw"]}


def needs(*libs):
    for lib in libs:
        if not have(lib):
            pytest.skip(f"needs {lib}, which is not installed")


# ------------------------------------------------------------ containers

@pytest.fixture(scope="module")
def containers(caps, tmp_path_factory):
    """The sparse capture as ``.iq``, converted by the CLI to each container
    of ``CONVERSIONS`` whose library is installed: ``{kind: path}``."""
    from sdr_channelizer_tpu_torch.io import iqpacket

    tmp = str(tmp_path_factory.mktemp("containers"))
    samples = caps["sparse"]
    src = os.path.join(tmp, "sparse.iq")
    iqpacket.write_iq(src, iqpacket.IqHeader(
        frequency_hz=0.0, bandwidth_hz=FS, sample_rate_sps=FS,
        rx_gain_db=0.0, num_samples=len(samples), bit_width=BIT_WIDTH,
        sample_start_time=0.0), samples)
    paths = {"iq": src}
    for kind, flags in CONVERSIONS.items():
        if "--v73" in flags and not have("h5py"):
            continue
        paths[kind] = run_cli(["convert", src, "--out-dir",
                               os.path.join(tmp, kind)] + flags)[-1]
    return paths


@pytest.fixture(scope="module")
def iq_pdws(pipe, containers):
    """The ``.iq`` file's PDWs through the main path."""
    from sdr_channelizer_tpu_torch.io.convert import load_capture_raw

    raw, bw, meta = load_capture_raw(containers["iq"])
    return pipe.extract_fused(raw, bw, fs=float(meta["fs"]))


@pytest.mark.parametrize("kind", ["iq", "npz_raw", "mat_raw", "mat73_raw"])
def test_raw_container(pipe, caps, containers, iq_pdws, kind):
    """A raw container's payload is the ``.iq`` payload; through the main
    path it launches K1 once and gives the ``.iq`` file's PDWs bit for
    bit."""
    from sdr_channelizer_tpu_torch.io.convert import load_capture_raw
    from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel as ck

    if kind == "mat73_raw":
        needs("h5py")
    raw, bw, meta = load_capture_raw(containers[kind])
    check(raw is not None and raw.dtype == np.int16
          and bw == BIT_WIDTH and np.array_equal(raw, caps["sparse"]),
          f"{kind}: the raw payload is not the .iq payload")
    ck.launches = 0
    got = pipe.extract_fused(raw, bw, fs=float(meta["fs"]))
    check(ck.launches == 1, f"{kind}: K1 launched {ck.launches} "
                            f"times, not once")
    pdws_identical(got, iq_pdws, f"{kind} container vs the .iq file")


def test_normalised_container(pipe, containers, iq_pdws):
    """The normalised ``.npz`` through ``extract``: the cm2 form on float
    planes, once a run of its staged step (the replay, and the eager
    warm-up where the call captures); the ``.iq`` file's PDWs within the
    float bars."""
    from sdr_channelizer_tpu_torch.io.convert import load_capture
    from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel as ck

    iq, meta = load_capture(containers["npz"])
    ck.launches = 0
    misses = pipe._staged_forward_fused.misses
    got = pipe.extract(iq, fs=float(meta["fs"]))
    check(ck.launches == step_runs(pipe._staged_forward_fused, misses),
          "normalised .npz: the cm2 form on float planes was not launched "
          "once a run")
    pdws_agree(got, iq_pdws, "normalised .npz container vs the .iq file")


def test_channelize_on_the_card(caps, containers, tmp_path):
    """``channelize`` on the card: B9 once a file, chan_iq held against the
    kernel's plain version on the same planes, and equal across the
    containers."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel as ck

    chan = Channelizer.create(M_MAIN)
    deq = iqpacket.to_complex(caps["sparse"], BIT_WIDTH)
    xr = torch.as_tensor(np.ascontiguousarray(deq.real), device=DEVICE)
    xi = torch.as_tensor(np.ascontiguousarray(deq.imag), device=DEVICE)
    want = ck.channelize_complex_planes_plain(xr, xi, chan.taps_rev)
    del xr, xi
    y_ref = None
    for kind in ("iq", "npz_raw", "mat_raw"):
        npz = os.path.join(str(tmp_path), f"chan_{kind}.npz")
        ck.launches_complex = 0
        run_cli(["channelize", containers[kind], "--out", npz])
        check(ck.launches_complex == 1, f"channelize {kind}: B9 launched "
                                        f"{ck.launches_complex} times")
        y = np.load(npz)["chan_iq"]
        check(y.shape == (FRAMES_MAIN, M_MAIN),
              f"channelize {kind}: chan_iq of shape {y.shape}")
        if y_ref is None:
            y_ref = y
            yt = torch.as_tensor(y, device=DEVICE).to(torch.complex64)
            check(bool(torch.isfinite(yt).all()), "channelize: non-finite "
                                                 "chan_iq")
            check(bool(torch.allclose(yt, want, rtol=MAG_TOL, atol=MAG_TOL)),
                  f"channelize: chan_iq differs from the plain version "
                  f"(max |d| {float((yt - want).abs().max())})")
            del yt
        else:
            check(np.array_equal(y, y_ref), f"channelize {kind}: chan_iq "
                                            "differs from the .iq file's")


def test_waterfall_windows(caps, tmp_path):
    """The waterfall's windows on the card, whatever is installed: the
    renderer replaced by a recorder, B9 once a window, each |y| held
    against |plain| on the window's planes."""
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel as ck
    from sdr_channelizer_tpu_torch.viz import plots

    chan = Channelizer.create(M_MAIN)
    deq = iqpacket.to_complex(caps["sparse"], BIT_WIDTH)
    seen = []
    real_png = plots.waterfall_png
    plots.waterfall_png = lambda p, y, *a, **k: seen.append(y)
    try:
        ck.launches_complex = 0
        plots.waterfall_window_pngs(os.path.join(str(tmp_path), "windows"),
                                    deq, FS, M_MAIN, limit=4, device=DEVICE)
    finally:
        plots.waterfall_png = real_png
    check(len(seen) == 4 and ck.launches_complex == 4,
          f"waterfall windows: {len(seen)} windows, B9 launched "
          f"{ck.launches_complex} times")
    win = int(5e-3 * FS) // M_MAIN * M_MAIN
    for k, y in enumerate(seen):
        w = deq[k * 100 * M_MAIN: k * 100 * M_MAIN + win]
        pw = ck.channelize_complex_planes_plain(
            torch.as_tensor(np.ascontiguousarray(w.real), device=DEVICE),
            torch.as_tensor(np.ascontiguousarray(w.imag), device=DEVICE),
            chan.taps_rev)
        pm = torch.sqrt(pw.real * pw.real + pw.imag * pw.imag)
        yt = torch.as_tensor(y, device=DEVICE)
        check(yt.shape == pm.shape and bool(torch.isfinite(yt).all()),
              f"waterfall window {k}: |y| of shape {tuple(yt.shape)}")
        check(bool(torch.allclose(yt, pm, rtol=MAG_TOL, atol=MAG_TOL)),
              f"waterfall window {k}: |y| differs from |plain| "
              f"(max |d| {float((yt - pm).abs().max())})")


@pytest.mark.parametrize("video", [False, True], ids=["frames", "video"])
def test_channelize_frames(containers, tmp_path, video):
    """``channelize --frames-dir`` (with ``matplotlib``): four frames, B9
    once for the file and once a frame; with ``--video`` (with ``cv2`` or
    ``ffmpeg`` as well) a video file that is not empty."""
    from sdr_channelizer_tpu_torch.ops.cuda import channelizer_kernel as ck

    needs("matplotlib")
    if video and not have("cv2") and shutil.which("ffmpeg") is None:
        pytest.skip("needs cv2 or ffmpeg, neither is installed")
    tmp = str(tmp_path)
    argv = ["channelize", containers["iq"], "--out",
            os.path.join(tmp, "c.npz"), "--frames-dir",
            os.path.join(tmp, "frames"), "--frame-limit", "4"]
    if video:
        argv += ["--video", os.path.join(tmp, "waterfall.mp4")]
    ck.launches_complex = 0
    printed = run_cli(argv)
    frames = sum(p.endswith(".png") for p in printed)
    check(frames == 4 and ck.launches_complex == 1 + frames,
          f"channelize --frames-dir: {frames} frames, B9 launched "
          f"{ck.launches_complex} times")
    check(not video or os.path.getsize(printed[-1]) > 0,
          "channelize --video: no video")


def spectrogram_f64(iq: np.ndarray, length: int) -> np.ndarray:
    """The spectrogram's float64 oracle: the same Hamming-windowed frames,
    FFT, ``fftshift``, |.|^2."""
    w = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(length) / (length - 1))
    frames = iq[: len(iq) // length * length].reshape(-1, length)
    spec = np.fft.fft(frames.astype(np.complex128) * w, axis=-1)
    return np.abs(np.fft.fftshift(spec, axes=-1)) ** 2


def test_spectrogram(card):
    """The spectrogram of 16,000,000 samples packed at bit width 12, window
    768, within SPEC_TOL of the largest power from a float64 STFT and from
    ``stft_power`` on the float capture; its TF32 products refused."""
    from sdr_channelizer_tpu_torch.dsp.spectrogram import (
        stft_power, stft_power_packed)
    from sdr_channelizer_tpu_torch.io import iqpacket

    _, wiq = wideband_capture(WIDE_SAMPLES, 1e-3, 1234, seed=3)
    wsamples = bench.quantize(wiq)
    del wiq
    length = 768
    n_frames = WIDE_SAMPLES // length
    xq = torch.as_tensor(pack(wsamples), device=DEVICE)
    power = stft_power_packed(xq, BIT_WIDTH, device=DEVICE)
    check(power.shape == (n_frames, length) and power.dtype == torch.float32
          and bool(torch.isfinite(power).all()),
          f"spectrogram: {tuple(power.shape)} {power.dtype}")
    deq = iqpacket.to_complex(wsamples, BIT_WIDTH)
    oracle = spectrogram_f64(deq, length)
    top = float(oracle.max())
    err64 = float(np.abs(power.cpu().numpy() - oracle).max()) / top
    del oracle
    check(err64 <= SPEC_TOL, f"spectrogram: {err64} of the largest power "
                             f"from the float64 STFT")
    xc = torch.as_tensor(deq, device=DEVICE)
    del deq
    err_float = max_abs(power, stft_power(xc, device=DEVICE)) / top
    check(err_float <= SPEC_TOL, f"spectrogram: {err_float} of the largest "
                                 f"power from stft_power")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        stft_power_packed(xq[: 4 * length], BIT_WIDTH, device=DEVICE)
        refused = False
    except RuntimeError:
        refused = True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(refused, "spectrogram: TF32 products were not refused")


# ------------------------------------------------------------------- CLI

SPEC = dict(sample_rate_sps=56e6, duration_sec=2e-3, frequency_hz=7.3e6,
            pulse_width_sec=100e-6, pri_sec=500e-6, start_index=1234,
            noise_std=3e-3)
COMMON = ["--max-pulses", "64", "--max-pulse-samples", "1024",
          "--device", DEVICE]
T_START = 1723800000.0


@pytest.fixture(scope="module")
def cli_capture(card, tmp_path_factory):
    """A synthetic ``.iq`` file through ``pdw --channelized`` on the card:
    ``(directory, the .iq path, the PDWs' .npz)``."""
    from sdr_channelizer_tpu_torch.cli.main import main
    from sdr_channelizer_tpu_torch.signal.synth import (
        PulseTrainSpec, write_training_iq)

    tmp = str(tmp_path_factory.mktemp("cli"))
    path = os.path.join(tmp, "cap.iq")
    out = os.path.join(tmp, "pdw.npz")
    write_training_iq(path, PulseTrainSpec(**SPEC), sample_start_time=T_START)
    rc = main(["pdw", path, "--channelized", "--out", out] + COMMON)
    check(rc == 0, f"cli: exit code {rc}")
    return tmp, path, out


@contextlib.contextmanager
def extractors_made():
    """The ``StreamingExtractor``s made inside the block, in a list."""
    from sdr_channelizer_tpu_torch.dsp import streaming

    made = []
    init = streaming.StreamingExtractor.__post_init__

    def keep(self):
        init(self)
        made.append(self)

    streaming.StreamingExtractor.__post_init__ = keep
    try:
        yield made
    finally:
        streaming.StreamingExtractor.__post_init__ = init


def staged_calls(made: list, names) -> None:
    """Fails unless each step of ``names`` ran staged on the card over the
    extractors ``made``, every call a hit or a capture."""
    out = {n: [sum(getattr(e, f"_staged_{n}").hits for e in made),
               sum(getattr(e, f"_staged_{n}").misses for e in made)]
           for n in names}
    check(bool(made) and all(m > 0 and not e._eager for n, (h, m) in
                             out.items() for e in made),
          f"cli --stream: the staged steps did not run: {out}")


def test_cli_pdw(cli_capture):
    """``pdw --channelized`` against the generator's truth; the same
    samples as two files through ``pdw --stream`` (channelized and
    wideband, their steps staged); ``pdw`` without ``--channelized``
    (wideband) against the truth and against its streamed run."""
    from sdr_channelizer_tpu_torch.cli.main import main
    from sdr_channelizer_tpu_torch.io import iqpacket
    from sdr_channelizer_tpu_torch.signal.synth import (
        PulseTrainSpec, pulse_starts)

    tmp, path, pdw_npz = cli_capture
    p = dict(np.load(pdw_npz))
    # the same samples as two contiguous files through pdw --stream
    hdr, samples = iqpacket.read_iq(path)
    samples = np.asarray(samples)
    half = len(samples) // 2
    parts = [os.path.join(tmp, f"part{i}.iq") for i in range(2)]
    for i, part in enumerate((samples[:half], samples[half:])):
        iqpacket.write_iq(parts[i], dataclasses.replace(
            hdr, num_samples=len(part),
            sample_start_time=hdr.sample_start_time
            + i * half / hdr.sample_rate_sps), part)
    out = os.path.join(tmp, "pdw_stream.npz")
    with extractors_made() as made:
        rc = main(["pdw", *parts, "--stream", "--channelized",
                   "--block-frames", "1024", "--checkpoint-dir",
                   os.path.join(tmp, "ck"), "--out", out] + COMMON)
    check(rc == 0, f"cli --stream: exit code {rc}")
    staged_calls(made, ("fused_block", "floor_block"))
    ps = dict(np.load(out))
    out = os.path.join(tmp, "pdw_stream_wide.npz")
    with extractors_made() as made:
        rc = main(["pdw", *parts, "--stream", "--max-pulses", "64",
                   "--max-pulse-samples", "8192", "--block-frames",
                   "65536", "--device", DEVICE, "--out", out])
    check(rc == 0, f"cli wideband --stream: exit code {rc}")
    staged_calls(made, ("detect_block",))
    psw = dict(np.load(out))

    out = os.path.join(tmp, "pdw_wide.npz")
    rc = main(["pdw", path, "--max-pulses", "64", "--max-pulse-samples",
               "8192", "--device", DEVICE, "--out", out])
    check(rc == 0, f"cli wideband: exit code {rc}")
    pw = dict(np.load(out))

    spec = PulseTrainSpec(**SPEC)
    starts = pulse_starts(spec)
    sel = (p["snr"] > 25) & (np.abs(p["freq"] - spec.frequency_hz) < 0.5e6)
    check(int(sel.sum()) == len(starts),
          f"cli: {int(sel.sum())} pulses in the tone's bin, {len(starts)} sent")
    toa = p["toa"][sel] - T_START
    want = (starts + 1) / spec.sample_rate_sps
    check(float(np.abs(toa - want).max()) < 4e-6, "cli: TOA off the truth")
    check(float(np.abs(p["pw"][sel] - spec.pulse_width_sec).max()) < 12e-6,
          "cli: pulse width off the truth")
    pdws_agree(ps, p, "cli --stream vs cli")
    pdws_agree(psw, pw, "cli wideband --stream vs cli wideband")
    check(len(pw["toa"]) == len(starts),
          f"cli wideband: {len(pw['toa'])} pulses, {len(starts)} sent")
    check(float(np.abs(pw["toa"] - T_START - want).max()) < 0.5e-6
          and float(np.abs(pw["pw"] - spec.pulse_width_sec).max()) < 1e-6
          and float(np.abs(pw["freq"] - spec.frequency_hz).max()) < 2e3,
          "cli wideband: TOA, width or frequency off the truth")


@pytest.fixture(scope="module")
def recorded(card, tmp_path_factory):
    """Three dwells recorded by ``record`` with the in-process emulator."""
    from sdr_channelizer_tpu_torch.cli.main import main

    rec = str(tmp_path_factory.mktemp("rec"))
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = main(["record", "1000", "8", "2", "62", "0.01", "0.03", "0",
                   "--out-dir", rec, "--offset-mhz", "0.31", "--pw-us",
                   "100", "--pri-us", "2000", "--noise-db", "-55",
                   "--python-emulator"])
    files = said.getvalue().split()
    check(rc == 0 and len(files) == 3,
          f"cli record: exit {rc}, {len(files)} files")
    return files


def test_cli_capture_tier(recorded):
    """The capture tier: ``predict`` on the recorded dwells, ``track``
    three dwells, ``gain-search``."""
    from sdr_channelizer_tpu_torch.cli.main import main

    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = main(["predict", *recorded, "--max-pulse-samples", "4096",
                   "--device", DEVICE])
    predicted = said.getvalue()
    check(rc == 0 and "Next event:" in predicted,
          f"cli predict: exit {rc}: {predicted[-300:]}")
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = main(["track", "1000", "8", "1", "60", "0.08", "0.24",
                   "--offset-mhz", "0.1", "--pw-us", "10", "--pri-us",
                   "5000", "--noise-db", "-55", "--amplitude", "0.9",
                   "--device", DEVICE])
    tracked = said.getvalue().splitlines()
    check(rc == 0 and len(tracked) == 3
          and all("pulses=" in t for t in tracked),
          f"cli track: exit {rc}: {tracked}")
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = main(["gain-search", "1000", "8", "1", "64", "0.002", "0.02",
                   "--offset-mhz", "0.13", "--noise-db", "-300"])
    check(rc == 0 and "Max unsaturated gain: 59.0 dB" in said.getvalue(),
          f"cli gain-search: exit {rc}")


CLI_CONTAINERS = [["--raw"], [], ["--mat", "--raw"], ["--mat"],
                  ["--mat", "--v73", "--raw"]]


def convert(tmp: str, path: str, flags) -> str:
    name = "_".join(f.lstrip("-") for f in flags) or "npz"
    out = run_cli(["convert", path, "--out-dir",
                   os.path.join(tmp, "views", name)] + flags)[-1]
    check(os.path.getsize(out) > 0, f"cli convert {flags}: empty file")
    return out


@pytest.mark.parametrize(
    "flags", CLI_CONTAINERS,
    ids=["_".join(f.lstrip("-") for f in fl) or "npz" for fl in CLI_CONTAINERS])
def test_cli_convert_and_pdw(cli_capture, flags):
    """``convert`` to a container, then ``pdw --channelized`` on it: a raw
    payload gives the ``.iq`` file's PDWs bit for bit (the same packed main
    path), a float one within the float bars."""
    if "--v73" in flags:
        needs("h5py")
    tmp, path, pdw_npz = cli_capture
    c = convert(tmp, path, flags)
    npz = os.path.join(os.path.dirname(c), "pdw.npz")
    run_cli(["pdw", c, "--channelized", "--out", npz] + COMMON)
    (pdws_identical if "--raw" in flags else pdws_agree)(
        dict(np.load(npz)), dict(np.load(pdw_npz)), f"cli pdw {c}")


def test_cli_pngs(cli_capture, recorded):
    """With ``matplotlib``: ``spectrogram`` and ``plot`` of the ``.iq``
    file and of every container, ``pdw --png`` and ``predict --png``, each
    a PNG."""
    needs("matplotlib")
    tmp, path, _ = cli_capture
    d = os.path.join(tmp, "views")
    containers = [path] + [convert(tmp, path, flags) for flags in
                           CLI_CONTAINERS
                           if "--v73" not in flags or have("h5py")]
    pngs = []
    for c in containers:
        pngs += run_cli(["spectrogram", c, "--out-dir",
                         os.path.join(d, "spec", str(len(pngs)))])
        pngs += run_cli(["plot", c, "--out-dir",
                         os.path.join(d, "plot", str(len(pngs)))])
    png = os.path.join(d, "pdw.png")
    pngs.append(run_cli(["pdw", path, "--channelized", "--out",
                         os.path.join(d, "pdw_png.npz"), "--png", png]
                        + COMMON)[-1])
    png = os.path.join(d, "predict.png")
    run_cli(["predict", *recorded, "--max-pulse-samples", "4096",
             "--device", DEVICE, "--png", png])
    pngs.append(png)
    for p in pngs:
        with open(p, "rb") as f:
            check(f.read(8) == b"\x89PNG\r\n\x1a\n", f"cli: {p} is not a PNG")


def test_cli_txrx_and_provision(cli_capture):
    """``txrx`` with a Barker-13 pulse: the matched filter finds the delay
    of 100 samples; ``provision --dry-run`` prints its three commands."""
    from sdr_channelizer_tpu_torch.capture.txrx import matched_filter_delay
    from sdr_channelizer_tpu_torch.io import iqpacket

    tmp = cli_capture[0]
    tx, rx = run_cli(["txrx", "1000", "8", "8", "0", "0.01", "0.004",
                      "10e-6", "1e-3", "--barker13", "--out-dir",
                      os.path.join(tmp, "views", "txrx")])
    tx_iq, rx_iq = (iqpacket.to_complex(np.asarray(iqpacket.read_iq(f)[1]),
                                        12) for f in (tx, rx))
    delay = matched_filter_delay(tx_iq, rx_iq, max_lag=8000)
    check(delay == 100, f"cli txrx: matched-filter delay {delay}, not 100")
    lines = run_cli(["provision", "A5", "--dry-run"])
    check(lines == ["bladeRF-cli -l ~/workarea/hostedxA5_v0.15.3.rbf",
                    "bladeRF-cli -f ~/workarea/bladeRF_fw_v2.4.0.img",
                    "bladeRF-cli -e info -e version"],
          f"cli provision --dry-run: {lines}")
