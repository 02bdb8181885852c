"""sdr_channelizer_tpu_torch — the PyTorch/CUDA port of ``sdr_channelizer_tpu``.

A second package beside the JAX one, with the same sub-package layout so a
reader finds each counterpart (``config``, ``ops``, ``dsp``, ``models``,
``parallel``, ``io``, ``signal``, ``capture``, ``utils``, ``viz``,
``cli``).  Plain tensor code is PyTorch; every kernel the JAX package wrote
in Pallas is a CUDA C++ kernel written by hand for Hopper (``ops/cuda``,
sources in ``ops/cuda/csrc``), built with ``nvcc`` at first use.  The package imports
``torch``, ``numpy`` and ``scipy`` only: never ``jax`` and nothing of the JAX
package; ``matplotlib``, ``h5py`` and ``cv2`` are imported by the functions
that use them.

Ported so far: packed int16/int8 capture -> channelizer -> per-band noise
floor -> hysteresis latch -> pulse statistics -> PDWs
(``models.pipeline.ChannelizerPipeline.extract_fused``), the FFT oracle
route (``extract``), wideband extraction, blockwise streaming over
multi-file captures with checkpoint/resume (``dsp.streaming``), events and
the closed-loop tracker, every capture container (``io.convert``,
``io.native``), the spectrogram, the plots and waterfall video, TX/RX
loopback, the radio backends and stage profiling, time x channel sharding
over a device mesh (``parallel``, ``pdw --shards``), and every CLI command
of the JAX package but ``bench``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no card present the default raises.
"""

__version__ = "0.1.0"

from sdr_channelizer_tpu_torch import config as config  # noqa: F401
from sdr_channelizer_tpu_torch._device import resolve_device  # noqa: F401
