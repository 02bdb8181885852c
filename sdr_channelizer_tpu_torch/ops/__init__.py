"""Compute ops: prototype filter design, exact medians, rank search, and the
hand-written CUDA kernels (``ops.cuda``)."""

from sdr_channelizer_tpu_torch.ops.filters import (  # noqa: F401
    design_prototype_filter,
    kaiser_beta,
    polyphase_decompose,
    reversed_polyphase,
)
from sdr_channelizer_tpu_torch.ops.medians import masked_median, median  # noqa: F401
