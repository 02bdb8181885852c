"""``StreamingExtractor.extract_segment_fused`` over a segment of
contiguous ``.iq`` files, one extractor held for the window, as ``pdw
--channelized --stream`` calls it (``cli/main.py:283-310``): the files'
headers read into a ``CaptureSet``, the two-pass exact floor and the
detection pass block by block from the files, no checkpoint."""

import math

from sdr_channelizer_tpu_torch.dsp.channelizer import Channelizer
from sdr_channelizer_tpu_torch.dsp.streaming import (
    CaptureSet,
    StreamingExtractor,
)
from sdr_channelizer_tpu_torch.utils.metrics import Counters

from chanbench.harness import load_module, staged_steps


class Entry:
    def __init__(self, cfg: dict, mix: dict, device):
        self.cfg = cfg
        self.block_frames = int(mix["block_frames"])
        pdw_config = load_module("entries", "extract_fused").pdw_config
        self.counters = Counters()
        self.ext = StreamingExtractor(
            channelizer=Channelizer.create(
                cfg["num_bands"], taps_per_band=cfg["taps_per_band"],
                stopband_atten_db=cfg["stopband_atten_db"]),
            pdw_cfg=pdw_config(cfg), block_frames=self.block_frames,
            counters=self.counters, device=device)

    def __call__(self, item) -> dict:
        segments = CaptureSet.from_paths(item.paths).segments
        if len(segments) != 1:
            raise RuntimeError(f"the item's files form {len(segments)} "
                               f"segments, not one")
        seg = segments[0]
        return self.ext.extract_segment_fused(
            seg, fc=seg.headers[0].frequency_hz, checkpoint_dir=None)

    def graphs(self) -> list:
        return staged_steps(self.ext)

    def batches(self, item) -> int:
        frames = item.samples // self.cfg["num_bands"]
        return max(math.ceil(frames / self.block_frames), 1)


def make(cfg: dict, mix: dict, run, device) -> Entry:
    return Entry(cfg, mix, device)
