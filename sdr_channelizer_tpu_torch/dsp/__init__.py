"""DSP layer: channelizer and PDW extraction."""

from sdr_channelizer_tpu_torch.dsp.channelizer import (  # noqa: F401
    Channelizer,
    center_frequencies,
    channelize,
    dft_matrix,
)
from sdr_channelizer_tpu_torch.dsp.pdw import (  # noqa: F401
    PdwBatch,
    extract_pdws_channelized,
    finalize_pdws,
)
