"""The port's hand-written Hopper kernels (the counterpart of the JAX
package's ``ops/pallas``): CUDA C++ sources in ``csrc/``, built with
``nvcc`` at first use, one wrapper module per kernel with the kernel's
plain PyTorch version beside it.

``KERNELS`` and ``PLAIN`` name the kernel stages of the single-shot routes,
of the streamed path and of the wideband path: the first holds the wrappers
(the CUDA kernels for CUDA tensors), the second the plain PyTorch versions,
which the checks run beside the kernels on the same device.

Each wrapper counts its launches in a module attribute named
``launches*``; :func:`launch_counts` reads them all and
:func:`add_launch_counts` adds to them (a replayed CUDA graph launches
without running the wrappers, ``_staging``)."""

import dataclasses
from typing import Callable, Dict, Tuple

from sdr_channelizer_tpu_torch.ops.cuda import (
    channelizer_kernel,
    latch_kernel,
    nf_kernel,
    pulse_stats_kernel,
    transpose_kernel,
)
from sdr_channelizer_tpu_torch.ops.cuda.channelizer_kernel import (  # noqa: F401
    channelize_complex,
    channelize_complex_plain,
    channelize_complex_planes,
    channelize_complex_planes_plain,
    channelize_streams,
    channelize_streams_cm,
    channelize_streams_cm2,
    channelize_streams_cm2_plain,
    channelize_streams_cm_plain,
    channelize_streams_packed,
    channelize_streams_packed_cm,
    channelize_streams_packed_cm2,
    channelize_streams_packed_cm2_plain,
    channelize_streams_packed_cm_plain,
    channelize_streams_packed_plain,
    channelize_streams_plain,
)
from sdr_channelizer_tpu_torch.ops.cuda.latch_kernel import (  # noqa: F401
    latch_cumsums,
    latch_cumsums_cm,
    latch_cumsums_cm_plain,
    latch_cumsums_plain,
)
from sdr_channelizer_tpu_torch.ops.cuda.nf_kernel import (  # noqa: F401
    noise_floor_cm,
    noise_floor_cm_plain,
)
from sdr_channelizer_tpu_torch.ops.cuda.pulse_stats_kernel import (  # noqa: F401
    pulse_stats,
    pulse_stats_dense,
    pulse_stats_dense_plain,
    pulse_stats_plain,
)
from sdr_channelizer_tpu_torch.ops.cuda.transpose_kernel import (  # noqa: F401
    cm_streams,
    cm_streams_plain,
    wideband_streams,
    wideband_streams_plain,
)


@dataclasses.dataclass(frozen=True)
class StageOps:
    """The kernel stages, as callables: the four of the single-shot main
    path, then the streamed block's front end (``channelize_cm``), its
    time-major latch (``latch_tm``) and the flat-list statistics, then the
    flip (``cm_streams``), the flat front end (``channelize_flat``) and the
    complex bands (``channelize_complex``, from two float32 planes).  The
    ``*_planes`` stages are the three stream front ends on two planes
    instead of packed pairs.  ``wideband_streams`` makes the wideband
    path's one-channel streams from its complex capture."""

    channelize: Callable
    noise_floor: Callable
    latch: Callable
    pulse_stats: Callable
    channelize_cm: Callable
    latch_tm: Callable
    pulse_stats_dense: Callable
    cm_streams: Callable
    channelize_flat: Callable
    channelize_complex: Callable
    channelize_planes: Callable
    channelize_cm_planes: Callable
    channelize_flat_planes: Callable
    wideband_streams: Callable


KERNELS = StageOps(channelize_streams_packed_cm2, noise_floor_cm,
                   latch_cumsums_cm, pulse_stats,
                   channelize_streams_packed_cm, latch_cumsums,
                   pulse_stats_dense, cm_streams, channelize_streams_packed,
                   channelize_complex_planes, channelize_streams_cm2,
                   channelize_streams_cm, channelize_streams,
                   wideband_streams)
PLAIN = StageOps(channelize_streams_packed_cm2_plain, noise_floor_cm_plain,
                 latch_cumsums_cm_plain, pulse_stats_plain,
                 channelize_streams_packed_cm_plain, latch_cumsums_plain,
                 pulse_stats_dense_plain, cm_streams_plain,
                 channelize_streams_packed_plain,
                 channelize_complex_planes_plain, channelize_streams_cm2_plain,
                 channelize_streams_cm_plain, channelize_streams_plain,
                 wideband_streams_plain)


_COUNTED = (channelizer_kernel, latch_kernel, nf_kernel, pulse_stats_kernel,
            transpose_kernel)


def launch_counts() -> Dict[Tuple[object, str], int]:
    """Every wrapper's launch count, keyed ``(module, attribute)``."""
    return {(mod, name): n for mod in _COUNTED for name, n in vars(mod).items()
            if name.startswith("launches") and isinstance(n, int)}


def add_launch_counts(delta: Dict[Tuple[object, str], int]) -> None:
    """Add ``delta`` (keyed as :func:`launch_counts`) to the counts."""
    for (mod, name), n in delta.items():
        if n:
            setattr(mod, name, getattr(mod, name) + n)
