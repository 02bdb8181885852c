"""Model layer: end-to-end signal-chain pipelines composed from the DSP core."""

from sdr_channelizer_tpu_torch.models.pipeline import (  # noqa: F401
    ChannelizerPipeline,
    WidebandPdwPipeline,
)
