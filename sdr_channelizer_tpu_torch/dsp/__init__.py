"""DSP layer: channelizer, PDW extraction, blockwise streaming and the
spectrogram (``dsp.spectrogram``)."""

from sdr_channelizer_tpu_torch.dsp.channelizer import (  # noqa: F401
    Channelizer,
    ChannelizerState,
    center_frequencies,
    channelize,
    channelize_planes,
    dft_matrix,
    resolve_method,
)
from sdr_channelizer_tpu_torch.dsp.pdw import (  # noqa: F401
    PdwBatch,
    extract_pdws,
    extract_pdws_channelized,
    finalize_pdws,
)
from sdr_channelizer_tpu_torch.dsp.streaming import (  # noqa: F401
    CaptureSet,
    Segment,
    StreamingExtractor,
)
