"""The generator repeats exactly from a seed and differs across seeds, for
every mix, and keeps each law's ranges."""

import os

import numpy as np
import pytest
import torch

from chanbench import generator, harness

MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(harness.HERE,
                                                       "traffic")))
CPU = torch.device("cpu")


def _cfg(n, bit_width=12, payload_dtype="int16"):
    return {"sample_rate_sps": 56e6, "dwell_samples": n,
            "bit_width": bit_width, "payload_dtype": payload_dtype,
            "center_frequency_hz": 0.0}


def _pool(mix_name, seed, n=56 * 2048):
    mix = harness.load_json(harness.HERE, "traffic", mix_name + ".json")
    cfg = _cfg(n)
    mix["pool"] = 2
    return generator.make_pool(mix, cfg, seed, CPU)


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_dwells(mix):
    a, b = _pool(mix, 2 ** 31 + 7), _pool(mix, 2 ** 31 + 7)
    for x, y in zip(a, b):
        assert x.start_times == y.start_times
        for p, q in zip(x.payloads, y.payloads):
            assert p.dtype == np.int16 and p.shape[1] == 2
            np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_other_dwells(mix):
    a, b = _pool(mix, 1), _pool(mix, 2)
    assert any(not np.array_equal(p, q) for x, y in zip(a, b)
               for p, q in zip(x.payloads, y.payloads))


def test_upstream_law_ranges():
    mix = harness.load_json(harness.HERE, "traffic", "ch56_sparse.json")
    fs = 56e6
    dwells = generator.draw_emitters(mix, 64, fs, np.random.default_rng(3))
    ems = [e for d in dwells for e in d]
    assert all(len(d) == 4 for d in dwells)
    assert all(-fs / 2 <= e.freq_hz <= fs / 2 for e in ems)
    assert all(560 <= e.pw <= 56000 for e in ems)
    assert all(max(560, e.pw) <= e.pri <= 560000 for e in ems)
    assert all(0 <= e.start < e.pri for e in ems)


def test_stratified_draws_cover_every_stratum():
    mix = {"noise_std": 0.001, "emitters": [
        {"count": 4, "freq_hz": 0.0, "pw_s": {"uniform": [0.0, 1.0]},
         "pri_s": 2.0, "amplitude": 1.0}]}
    for seed in (1, 2):
        dwells = generator.draw_emitters(mix, 8, 1000.0,
                                         np.random.default_rng(seed))
        pw = np.sort([e.pw for d in dwells for e in d]) / 1000.0
        assert np.all(np.floor(pw * 32) == np.arange(32))


def test_pulses_end_before_the_dwell():
    e = generator.Emitter(1e6, pw=100, pri=1000, start=950, amplitude=0.5,
                          phase=0.0)
    gen = torch.Generator().manual_seed(0)
    q = generator.quantise(generator.synth(2100, 56e6, 0.0, [e], gen, CPU),
                           _cfg(2100))
    on = np.flatnonzero(np.abs(q).sum(1))
    # pulses at 950 and 1950; the second would end at 2050 < 2100: kept
    assert on.min() == 950 and on.max() <= 2049 and len(on) <= 200


def test_stream_files_are_contiguous_iq_v3(tmp_path):
    from sdr_channelizer_tpu_torch.dsp.streaming import CaptureSet

    mix = harness.load_json(harness.HERE, "traffic", "ch56_stream.json")
    mix["pool"] = 2
    cfg = _cfg(56 * 1024)
    items = generator.make_pool(mix, cfg, 9, CPU, str(tmp_path))
    for item in items:
        seg = CaptureSet.from_paths(item.paths).segments
        assert len(seg) == 1 and seg[0].num_samples == item.samples
        raw = seg[0].read_samples_raw(0, item.samples)
        np.testing.assert_array_equal(raw, np.concatenate(item.payloads))
    assert len(CaptureSet.from_paths(
        [p for it in items for p in it.paths]).segments) == len(items)


def test_int8_payloads_as_the_8_bit_recorder_writes_them(tmp_path):
    from sdr_channelizer_tpu_torch.dsp.streaming import CaptureSet

    mix = harness.load_json(harness.HERE, "traffic", "ch56_stream.json")
    mix["pool"] = 1
    items = generator.make_pool(mix, _cfg(56 * 1024, 8, "int8"), 9, CPU,
                                str(tmp_path))
    raw = np.concatenate(items[0].payloads)
    assert raw.dtype == np.int8 and raw.min() >= -128 and raw.max() <= 127
    seg = CaptureSet.from_paths(items[0].paths).segments[0]
    np.testing.assert_array_equal(
        seg.read_samples_raw(0, items[0].samples), raw)


@pytest.mark.parametrize("bits,dtype", [(8, "int16"), (12, "int8"),
                                        (12, "float32")])
def test_a_payload_type_the_recorder_does_not_write_is_refused(bits, dtype):
    mix = harness.load_json(harness.HERE, "traffic", "ch56_sparse.json")
    mix["pool"] = 1
    with pytest.raises(ValueError, match="payload_dtype"):
        generator.make_pool(mix, _cfg(56 * 64, bits, dtype), 1, CPU)
