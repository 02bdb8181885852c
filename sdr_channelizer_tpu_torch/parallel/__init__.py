"""Distribution layer: the (time-blocks x channels) device mesh,
overlap-save halo exchange, cross-shard PDW latch chaining and merge.

The reference is single-process and single-device over USB (SURVEY.md
section 5.7-5.8); the JAX package added the scale-out design it never had,
and this is its port: the sample axis is sharded into time blocks, the
channel axis for PDW extraction (the DFT product split by columns, a band
slice into the channelizer kernel), FIR history and pulse halos pass between
neighbouring shards, and pulses straddling block edges are stitched exactly
by composing the detector's latch transfer functions across shards.  Shards
of one process may share a card; across processes the exchanges go through
``torch.distributed`` (``parallel.multihost``).
"""

from sdr_channelizer_tpu_torch.parallel.mesh import make_mesh, TIME_AXIS, CHAN_AXIS  # noqa: F401
from sdr_channelizer_tpu_torch.parallel.pipeline import (  # noqa: F401
    ShardedPipeline,
    sharded_channelize,
)
