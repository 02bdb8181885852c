"""The benchmark of sdr_channelizer_tpu_torch on one H100: capture to PDWs
at the upstream's 56 Msps deployments (``harness.py``)."""
