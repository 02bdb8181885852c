"""Synthetic signal generators: the ground-truth fixtures."""

from sdr_channelizer_tpu_torch.signal.synth import (  # noqa: F401
    PulseTrainSpec,
    pulse_starts,
    pulse_train,
    random_pulse_train_spec,
    write_training_iq,
)
