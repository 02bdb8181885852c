"""I/O layer: the versioned IqPacket binary format plus capture loading."""

from sdr_channelizer_tpu_torch.io.iqpacket import (  # noqa: F401
    IqHeader,
    encode_header,
    from_complex,
    parse_header,
    read_iq,
    to_complex,
    write_iq,
)
