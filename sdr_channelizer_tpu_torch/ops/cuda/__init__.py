"""The port's hand-written Hopper kernels (the counterpart of the JAX
package's ``ops/pallas``): CUDA C++ sources in ``csrc/``, built with
``nvcc`` at first use, one wrapper module per kernel with the kernel's
plain PyTorch version beside it.

``KERNELS`` and ``PLAIN`` name the four stages of the main path: the first
holds the wrappers (the CUDA kernels for CUDA tensors), the second the plain
PyTorch versions, which the checks run beside the kernels on the same
device."""

import dataclasses
from typing import Callable

from sdr_channelizer_tpu_torch.ops.cuda.channelizer_kernel import (  # noqa: F401
    channelize_streams_packed_cm2,
    channelize_streams_packed_cm2_plain,
)
from sdr_channelizer_tpu_torch.ops.cuda.latch_kernel import (  # noqa: F401
    latch_cumsums_cm,
    latch_cumsums_cm_plain,
)
from sdr_channelizer_tpu_torch.ops.cuda.nf_kernel import (  # noqa: F401
    noise_floor_cm,
    noise_floor_cm_plain,
)
from sdr_channelizer_tpu_torch.ops.cuda.pulse_stats_kernel import (  # noqa: F401
    pulse_stats,
    pulse_stats_plain,
)


@dataclasses.dataclass(frozen=True)
class StageOps:
    """The four kernel stages of the main path, as callables."""

    channelize: Callable
    noise_floor: Callable
    latch: Callable
    pulse_stats: Callable


KERNELS = StageOps(channelize_streams_packed_cm2, noise_floor_cm,
                   latch_cumsums_cm, pulse_stats)
PLAIN = StageOps(channelize_streams_packed_cm2_plain, noise_floor_cm_plain,
                 latch_cumsums_cm_plain, pulse_stats_plain)
