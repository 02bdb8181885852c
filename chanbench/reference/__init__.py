"""The plain reference of the benchmark: the same PDWs worked out again
from the same raw payloads, in plain PyTorch and NumPy.

It imports nothing of the program (``sdr_channelizer_tpu_torch``) and
nothing of the JAX package: its filter design, channelizer, noise floor,
latch, statistics and finalize are frozen copies of the port's oracle forms
(``ops/filters.py``, ``dsp/channelizer.py``'s frame convention with the DFT
as a product, ``dsp/pdw.py``'s ``extract_pdws_core`` /
``extract_pdws_block_core`` / ``block_transfer`` / ``finalize_pdws``,
``ops/medians.py``), which follow the upstream MATLAB line by line.

``precision`` is ``"float32"`` for the reference (products in full
float32: TF32 is switched off while it runs) or the control's lower
precision: ``"tf32"`` rounds both operands of the channelizer's DFT product
to TF32 (10 explicit mantissa bits, round to nearest), as a tensor core
does; ``"bfloat16"`` rounds the detection inputs (the band or wideband
samples) and the magnitudes to bfloat16.
"""

from chanbench.reference.pipeline import pdws  # noqa: F401
