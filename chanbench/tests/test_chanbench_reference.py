"""The reference against the port at a small size on the CPU: the exact
fields equal, the float fields within float32's reach."""

import numpy as np
import pytest
import torch

from chanbench import compare, generator, harness, reference

CPU = torch.device("cpu")


def _items(config, mix_name, n, seed=21):
    cfg = harness.load_json(harness.HERE, "configs", config + ".json")
    cfg["dwell_samples"] = n
    mix = harness.load_json(harness.HERE, "traffic", mix_name + ".json")
    mix["pool"] = 2
    return cfg, generator.make_pool(mix, cfg, seed, CPU)


@pytest.mark.parametrize("mix", ["ch56_dense", "ch56_sparse"])
def test_channelized_reference_is_the_ports_oracle(mix):
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.models import ChannelizerPipeline

    cfg, items = _items("ch56_bladerf12", mix, 56 * 4096)
    pipe = ChannelizerPipeline.create(
        56, PdwConfig.channelized(max_pulses=512, max_pulse_samples=4096),
        device="cpu")
    for it in items:
        x = it.payloads[0].astype(np.float32) / 2048.0
        port = pipe.extract(x[:, 0] + 1j * x[:, 1], fs=56e6,
                            sample_start_time=it.start_times[0])
        ref = reference.pdws(cfg, it.payloads, it.start_times[0])
        nums = compare.numbers(port, ref, 1e6, it.start_times[0], 1e6, 512)
        assert len(ref["toa"]) > 0
        assert nums["unpaired_pct"] == 0.0
        assert nums["mag_gap"] < 1e-4 and nums["snr_gap_db"] < 1e-3
        assert nums["freq_gap_hz"] < 50.0


def test_wideband_reference_is_the_ports_oracle():
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp import pdw

    cfg, items = _items("wb56_bladerf12", "wb56_pulsetrain", 1 << 18)
    for it in items:
        x = it.payloads[0].astype(np.float32) / 2048.0
        iq = torch.as_tensor(x[:, 0] + 1j * x[:, 1]).to(torch.complex64)
        batch = pdw.extract_pdws(iq, PdwConfig.wideband(
            max_pulses=512, max_pulse_samples=4096), stats="xla")
        port = pdw.finalize_pdws(batch, fs=56e6,
                                 sample_start_time=it.start_times[0])
        ref = reference.pdws(cfg, it.payloads, it.start_times[0])
        nums = compare.numbers(port, ref, 56e6, it.start_times[0], 56e6, 512)
        assert len(ref["toa"]) > 0
        assert {k: nums[k] for k in compare.NUMBERS} == dict.fromkeys(
            compare.NUMBERS, 0.0)


def test_streamed_contract_against_the_ports_streamed_oracle(tmp_path):
    from sdr_channelizer_tpu_torch.config import PdwConfig
    from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
    from sdr_channelizer_tpu_torch.dsp.streaming import (
        CaptureSet,
        StreamingExtractor,
    )

    cfg = harness.load_json(harness.HERE, "configs", "ch56_bladerf12.json")
    cfg.update(dwell_samples=56 * 2048, max_pulse_samples=256)
    mix = harness.load_json(harness.HERE, "traffic", "ch56_dense.json")
    mix.update(pool=1, files_per_item=2)
    (item,) = generator.make_pool(mix, cfg, 8, CPU, str(tmp_path))
    ext = StreamingExtractor(
        Channelizer.create(56), PdwConfig.channelized(
            max_pulses=512, max_pulse_samples=256), block_frames=1024,
        device="cpu")
    port = ext.extract_segment(CaptureSet.from_paths(item.paths).segments[0])
    ref = reference.pdws(cfg, item.payloads, item.start_times[0],
                         block_frames=1024)
    nums = compare.numbers(port, ref, 1e6, item.start_times[0], 1e6, 512,
                           1024)
    assert len(ref["toa"]) > 512     # more than one block's slots a band
    assert nums["unpaired_pct"] == 0.0 and nums["mag_gap"] < 1e-4


def test_block_contract_keeps_slots_a_block():
    cfg = harness.load_json(harness.HERE, "configs", "ch56_bladerf12.json")
    cfg.update(num_bands=1, max_pulses=2, max_pulse_samples=4)
    mag = torch.zeros(1, 40)
    for s in (1, 5, 9, 21, 25, 29):    # three pulses in each half
        mag[0, s:s + 2] = 100.0
    mag += 1.0
    ph = torch.zeros_like(mag)
    sat = torch.zeros_like(mag, dtype=torch.bool)
    nf = torch.ones(1)
    from chanbench.reference import pdw as rpdw

    batches, offsets = rpdw.extract_blocks(mag, ph, sat, nf, cfg, 20)
    toa = rpdw.merge(batches, offsets).toa_idx[rpdw.merge(
        batches, offsets).valid]
    assert toa.tolist() == [1, 5, 21, 25]
    one = rpdw.extract_core(mag, ph, sat, nf, cfg)
    assert one.toa_idx[one.valid].tolist() == [1, 5]
