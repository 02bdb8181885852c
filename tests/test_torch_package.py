"""The port as a package: it imports neither JAX nor the JAX package, its
codec writes the JAX codec's bytes, its CLI runs end to end on the CPU, and
its default device is the card."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from sdr_channelizer_tpu.io import iqpacket as jiq
from sdr_channelizer_tpu.signal import synth as jsynth
from sdr_channelizer_tpu_torch.cli.main import main
from sdr_channelizer_tpu_torch.io import iqpacket as tiq
from sdr_channelizer_tpu_torch.io.convert import load_capture_raw
from sdr_channelizer_tpu_torch.signal import synth as tsynth

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "sdr_channelizer_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_fresh_interpreter_imports_no_jax():
    code = (
        "import sys\n"
        "import sdr_channelizer_tpu_torch\n"
        "import sdr_channelizer_tpu_torch.cli.main\n"
        "import sdr_channelizer_tpu_torch.__main__\n"
        "import sdr_channelizer_tpu_torch.models.pipeline\n"
        "import sdr_channelizer_tpu_torch.ops.cuda\n"
        "import sdr_channelizer_tpu_torch.dsp.pdw\n"
        "import sdr_channelizer_tpu_torch.dsp.events\n"
        "import sdr_channelizer_tpu_torch.capture\n"
        "import sdr_channelizer_tpu_torch.capture.txrx\n"
        "import sdr_channelizer_tpu_torch.capture.vendor_api\n"
        "import sdr_channelizer_tpu_torch.dsp.spectrogram\n"
        "import sdr_channelizer_tpu_torch.io.convert\n"
        "import sdr_channelizer_tpu_torch.io.native\n"
        "import sdr_channelizer_tpu_torch.utils\n"
        "import sdr_channelizer_tpu_torch.utils.profiling\n"
        "import sdr_channelizer_tpu_torch.viz\n"
        "import sdr_channelizer_tpu_torch.parallel\n"
        "import sdr_channelizer_tpu_torch.parallel.mesh\n"
        "import sdr_channelizer_tpu_torch.parallel.pipeline\n"
        "import sdr_channelizer_tpu_torch.parallel.multihost\n"
        "import sdr_channelizer_tpu_torch.bench\n"
        "import sdr_channelizer_tpu_torch.bench_scaling\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sdr_channelizer_tpu', 'triton', 'matplotlib', "
        "'h5py', 'cv2')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_sources_name_neither_jax_nor_the_jax_package():
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|sdr_channelizer_tpu)(\.|\s|$)", re.M)
    sources = _port_sources()
    assert len(sources) > 20
    for path in sources:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_kernel_sources_are_in_the_package():
    csrc = os.path.join(PORT, "ops", "cuda", "csrc")
    assert sorted(f for f in os.listdir(csrc) if f.endswith(".cu")) == [
        "channelizer.cu", "latch.cu", "noise_floor.cu", "pulse_stats.cu",
        "transpose.cu"]


@pytest.mark.parametrize("bit_width", [8, 12, 16])
def test_iq_codec_writes_the_jax_codecs_bytes(tmp_path, bit_width):
    rng = np.random.default_rng(bit_width)
    iq = (0.5 * (rng.standard_normal(999) + 1j * rng.standard_normal(999))
          ).astype(np.complex64)
    kw = dict(frequency_hz=2.4e9, bandwidth_hz=50e6, sample_rate_sps=56e6,
              rx_gain_db=30.0, num_samples=len(iq), bit_width=bit_width,
              sample_start_time=1723800000.5, board_name="b", serial_number="s")
    a, b = tmp_path / "a.iq", tmp_path / "b.iq"
    jiq.write_iq(a, jiq.IqHeader(**kw), jiq.from_complex(iq, bit_width))
    tiq.write_iq(b, tiq.IqHeader(**kw), tiq.from_complex(iq, bit_width))
    assert a.read_bytes() == b.read_bytes()
    hdr, samples = tiq.read_iq(a)
    jhdr, jsamples = jiq.read_iq(b)
    assert hdr.bit_width == jhdr.bit_width == bit_width
    np.testing.assert_array_equal(np.asarray(samples), np.asarray(jsamples))
    np.testing.assert_array_equal(tiq.to_complex(np.asarray(samples), bit_width),
                                  jiq.to_complex(np.asarray(jsamples), bit_width))
    raw, bw, meta = load_capture_raw(str(a))
    assert bw == bit_width and meta["fs"] == 56e6 and raw.shape == (999, 2)


def test_synth_matches_jax_package():
    kw = dict(sample_rate_sps=8e6, duration_sec=1e-3, frequency_hz=1.7e6,
              pulse_width_sec=60e-6, pri_sec=300e-6, start_index=101,
              noise_std=5e-3)
    a = tsynth.pulse_train(tsynth.PulseTrainSpec(**kw), seed=3)
    b = jsynth.pulse_train(jsynth.PulseTrainSpec(**kw), seed=3)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tsynth.pulse_starts(tsynth.PulseTrainSpec(**kw)),
        jsynth.pulse_starts(jsynth.PulseTrainSpec(**kw)))


def test_cli_generate_then_pdw_on_the_cpu(tmp_path, capsys):
    assert main(["generate", "--out-dir", str(tmp_path), "--fs-msps", "8",
                 "--duration-sec", "2e-3", "--freq-mhz", "2.0", "--pw-us",
                 "100", "--pri-us", "500", "--noise-std", "3e-3"]) == 0
    path = capsys.readouterr().out.strip().splitlines()[-1]
    assert os.path.basename(path) == "2.0_MHz_100.0_us_500.0_us.iq"
    out = tmp_path / "pdw.npz"
    assert main(["pdw", path, "--channelized", "--max-pulses", "64",
                 "--max-pulse-samples", "256", "--device", "cpu",
                 "--out", str(out)]) == 0
    p = np.load(out)
    assert set(p.files) == {"toa", "freq", "pw", "mag", "snr", "sat", "channel"}
    sel = (p["snr"] > 25) & (np.abs(p["freq"] - 2.0e6) < 0.5e6)
    assert int(sel.sum()) == 4  # 2 ms of a 500 us PRI
    np.testing.assert_allclose(np.diff(p["toa"][sel]), 500e-6, atol=3e-6)
    assert np.all(np.abs(p["pw"][sel] - 100e-6) < 12e-6)
    assert np.all(np.diff(p["toa"]) >= 0)


def test_cli_bench_runs_the_harness(capsys):
    assert main(["bench", "--", "--cpu", "--bands", "8", "--frames", "4096",
                 "--iters", "2", "--rounds", "1"]) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    line = json.loads(line)
    assert line["metric"] == "channelize_pdw_throughput"
    assert line["device"] == "cpu" and line["ingest"] == "packed_int16"
    assert line["value"] > 0 and line["sparse_pulses_per_step"] > 0


@pytest.mark.parametrize("extra", [
    [],
    ["--stream"],
    ["--channelized"],
    ["--channelized", "--strict-halo"],
    ["--strict-halo"],
])
def test_cli_pdw_shards_runs_on_the_cpu(tmp_path, capsys, extra):
    """``--shards`` and ``--strict-halo`` are ported: a short capture
    runs over two time shards, wideband and channelized (``--stream``
    ignores the shards, as the JAX CLI does)."""
    assert main(["generate", "--out-dir", str(tmp_path), "--fs-msps", "8",
                 "--duration-sec", "2e-3", "--freq-mhz", "2.0", "--pw-us",
                 "100", "--pri-us", "500", "--noise-std", "3e-3"]) == 0
    path = capsys.readouterr().out.strip().splitlines()[-1]
    out = tmp_path / "pdw.npz"
    assert main(["pdw", path, "--shards", "2", "--max-pulses", "64",
                 "--max-pulse-samples", "256", "--device", "cpu", "--out",
                 str(out), *extra]) == 0
    said = capsys.readouterr().out
    p = np.load(out)
    assert set(p.files) == {"toa", "freq", "pw", "mag", "snr", "sat", "channel"}
    if "--channelized" in extra:
        sel = (p["snr"] > 25) & (np.abs(p["freq"] - 2.0e6) < 0.5e6)
        assert int(sel.sum()) == 4  # 2 ms of a 500 us PRI
        assert "(2 shards)" in said
    else:
        assert len(p["toa"]) >= 1


def test_default_device_is_the_card_and_its_absence_raises():
    from sdr_channelizer_tpu_torch import resolve_device
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer, channelize
    from sdr_channelizer_tpu_torch.models import ChannelizerPipeline

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ChannelizerPipeline.create(8)
    with pytest.raises(RuntimeError, match="CUDA device"):
        channelize(np.zeros(64, np.complex64), Channelizer.create(8))
    assert resolve_device("cpu").type == "cpu"


def test_kernel_build_is_lazy_and_fails_loudly_without_nvcc(monkeypatch):
    """Importing the wrappers builds nothing; asking for a library where
    there is no compiler raises, it does not fall back."""
    from sdr_channelizer_tpu_torch.ops.cuda import _build

    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    assert _build.library_path("latch") != _build.library_path("noise_floor")
    assert _build.library_path("latch").startswith(_build.BUILD_DIR)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return  # nvcc is installed here: nothing to refuse
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("latch")
