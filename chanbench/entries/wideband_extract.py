"""``io.iqpacket.to_complex`` then ``WidebandPdwPipeline.extract``, one
pipeline held for the window, as ``pdw`` without ``--channelized`` runs
them (``cli/main.py:410-415``): the capture dequantised on the host
(the span ``ingest``), copied into the staged step's input, the batch
finalized on the host."""

from sdr_channelizer_tpu_torch.io import iqpacket
from sdr_channelizer_tpu_torch.models import WidebandPdwPipeline

from chanbench.harness import load_module, staged_steps


class Entry:
    def __init__(self, cfg: dict, run, device):
        self.cfg = cfg
        self.run = run
        pdw_config = load_module("entries", "extract_fused").pdw_config
        self.pipe = WidebandPdwPipeline(pdw_cfg=pdw_config(cfg),
                                        device=device)

    def __call__(self, item) -> dict:
        with self.run.span("ingest"):
            x = iqpacket.to_complex(item.payloads[0], self.cfg["bit_width"])
        return self.pipe.extract(x, fs=self.cfg["sample_rate_sps"],
                                 fc=self.cfg["center_frequency_hz"],
                                 sample_start_time=item.start_times[0])

    def graphs(self) -> list:
        return staged_steps(self.pipe)


def make(cfg: dict, mix: dict, run, device) -> Entry:
    return Entry(cfg, run, device)
