"""``ChannelizerPipeline.extract_fused``, one pipeline held for the window,
on the raw integer payload as ``pdw --channelized`` calls it
(``cli/main.py:430-434``): the staged main path, the host payload copied
into the graph's input, the ``PdwBatch`` finalized on the host."""

from sdr_channelizer_tpu_torch.config import PdwConfig
from sdr_channelizer_tpu_torch.models import ChannelizerPipeline

from chanbench.harness import staged_steps


def pdw_config(cfg: dict) -> PdwConfig:
    return PdwConfig(
        snr_threshold_db=cfg["snr_threshold_db"],
        trailing_threshold_db=cfg["trailing_threshold_db"],
        saturation_level=cfg["saturation_level"],
        max_pulses=cfg["max_pulses"],
        max_pulse_samples=cfg["max_pulse_samples"])


class Entry:
    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.pipe = ChannelizerPipeline.create(
            cfg["num_bands"], pdw_cfg=pdw_config(cfg), device=device,
            taps_per_band=cfg["taps_per_band"],
            stopband_atten_db=cfg["stopband_atten_db"])

    def __call__(self, item) -> dict:
        raw = item.payloads[0]
        m = self.cfg["num_bands"]
        return self.pipe.extract_fused(
            raw[: len(raw) // m * m], bit_width=self.cfg["bit_width"],
            fs=self.cfg["sample_rate_sps"],
            fc=self.cfg["center_frequency_hz"],
            sample_start_time=item.start_times[0])

    def graphs(self) -> list:
        return staged_steps(self.pipe)


def make(cfg: dict, mix: dict, run, device) -> Entry:
    return Entry(cfg, device)
