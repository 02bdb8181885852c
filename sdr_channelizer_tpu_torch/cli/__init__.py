"""Command-line interface: ``python -m sdr_channelizer_tpu_torch <command>``
with ``generate`` and ``pdw --channelized`` ported so far."""

from sdr_channelizer_tpu_torch.cli.main import main  # noqa: F401
