"""Utilities: stage profiling and the structured metrics counters shared by
the CLI and the streamed path."""

from sdr_channelizer_tpu_torch.utils.profiling import StageTimer, trace  # noqa: F401
from sdr_channelizer_tpu_torch.utils.metrics import Counters  # noqa: F401
