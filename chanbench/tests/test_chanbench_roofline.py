"""The least bytes and operations of a step, from the configuration's
shapes."""

import math

import pytest

from chanbench import harness, roofline


def test_channelized_dwell():
    cfg = harness.load_json(harness.HERE, "configs", "ch56_bladerf12.json")
    n = cfg["dwell_samples"]
    batch = 56 * (512 * 26 + 4)
    assert roofline.batch_bytes(cfg) == batch
    assert roofline.least_bytes(cfg, n) == 4 * n + batch
    assert roofline.least_flops(cfg, n) == pytest.approx(
        (48 + 5 * math.log2(56)) * n)
    # the bytes bind over the channelizer's operations
    assert roofline.least_seconds(cfg, n) == pytest.approx(
        (4 * 14_680_064 + 745_696) / 3.35e12)


def test_wideband_dwell():
    cfg = harness.load_json(harness.HERE, "configs", "wb56_bladerf12.json")
    assert roofline.least_bytes(cfg, 16_000_000) == 64_000_000 + 512 * 26 + 4
    assert roofline.least_flops(cfg, 16_000_000) == 0.0


def test_streamed_segment_writes_a_batch_a_block():
    cfg = harness.load_json(harness.HERE, "configs", "ch56_bladerf12.json")
    n = 2 * cfg["dwell_samples"]
    assert roofline.least_bytes(cfg, n, batches=8) == \
        4 * n + 8 * roofline.batch_bytes(cfg)


def test_int8_payload_halves_the_bytes_and_the_operations_bind():
    cfg = dict(harness.load_json(harness.HERE, "configs",
                                 "ch56_bladerf12.json"),
               payload_dtype="int8", bit_width=8)
    n = cfg["dwell_samples"]
    assert roofline.least_bytes(cfg, n) == 2 * n + roofline.batch_bytes(cfg)
    assert roofline.least_seconds(cfg, n) == pytest.approx(
        roofline.least_flops(cfg, n) / 67e12)
