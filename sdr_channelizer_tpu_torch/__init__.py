"""sdr_channelizer_tpu_torch — the PyTorch/CUDA port of ``sdr_channelizer_tpu``.

A second package beside the JAX one, with the same sub-package layout so a
reader finds each counterpart (``config``, ``ops``, ``dsp``, ``models``,
``io``, ``signal``, ``utils``, ``cli``).  Plain tensor code is PyTorch; every kernel the
JAX package wrote in Pallas is a CUDA C++ kernel written by hand for Hopper
(``ops/cuda``, sources in ``ops/cuda/csrc``), built with ``nvcc`` at first
use.  The package imports ``torch`` and ``numpy`` only: never ``jax`` and
nothing of the JAX package.

Ported so far: packed int16/int8 capture -> channelizer -> per-band noise
floor -> hysteresis latch -> pulse statistics -> PDWs
(``models.pipeline.ChannelizerPipeline.extract_fused``), the FFT oracle
route (``extract``), blockwise streaming over multi-file captures with
checkpoint/resume (``dsp.streaming.StreamingExtractor``), and the
``generate`` / ``pdw --channelized`` / ``pdw --stream`` CLI.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no card present the default raises.
"""

__version__ = "0.1.0"

from sdr_channelizer_tpu_torch import config as config  # noqa: F401
from sdr_channelizer_tpu_torch._device import resolve_device  # noqa: F401
