"""Pulsed TX/RX loopback — the reference's ``cpp/tx_rx_pulses_usrp.cpp``
(SURVEY.md #10: transmit a 13-chip pulse as timed bursts while recording RX
continuously; write both sides as ``.iq`` files).  That source is stale and
not buildable in the reference; this is the working emulated equivalent:

* TX: a chip-structured pulse every PRI — flat phase by default, with the
  13-chip Barker BPSK variant the reference keeps commented out
  (``tx_rx_pulses_usrp.cpp:24, :212-213``) available via ``barker13=True``;
* channel: integer-sample delay + attenuation + AWGN (the physical loopback
  the reference runs over the air);
* RX: the TX stream through the channel, both quantized and written as v3
  ``.iq`` files with delay-corrected ``sampleStartTime``.

The matched-filter check (:func:`matched_filter_delay`) closes the loop the
reference closes by eyeballing plots: the recorded RX correlates at the
channel delay.  Host NumPy only; the files are byte for byte the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np

from sdr_channelizer_tpu_torch.io import iqpacket
from sdr_channelizer_tpu_torch.signal.synth import barker13_phase


@dataclasses.dataclass(frozen=True)
class TxRxSpec:
    """Mirrors the reference CLI: the 7 capture args + <chipWidthSec> <priSec>
    (``tx_rx_pulses_usrp.cpp:61-71``)."""

    sample_rate_sps: float = 8e6
    chip_width_sec: float = 10e-6
    pri_sec: float = 1e-3
    duration_sec: float = 10e-3
    num_chips: int = 13
    barker13: bool = False
    frequency_hz: float = 1e9
    # loopback channel
    delay_samples: int = 100
    attenuation_db: float = 20.0
    noise_std: float = 1e-3

    @property
    def chip_samples(self) -> int:
        return int(round(self.chip_width_sec * self.sample_rate_sps))

    @property
    def pulse_samples(self) -> int:
        return self.chip_samples * self.num_chips


def tx_waveform(spec: TxRxSpec) -> np.ndarray:
    """The transmitted baseband stream (complex64, unit amplitude pulses)."""
    n_total = int(round(spec.duration_sec * spec.sample_rate_sps))
    pw = spec.pulse_samples
    if spec.barker13:
        if spec.num_chips != 13:
            raise ValueError("barker13 requires 13 chips")
        pulse = np.exp(1j * barker13_phase(pw))
    else:
        pulse = np.ones(pw, np.complex128)  # flat phase (the enabled path)
    tx = np.zeros(n_total, np.complex128)
    pri = max(int(round(spec.pri_sec * spec.sample_rate_sps)), 1)
    for start in range(0, n_total - pw + 1, pri):
        tx[start : start + pw] = pulse
    return tx.astype(np.complex64)


def loopback(
    tx: np.ndarray, spec: TxRxSpec, seed: int = 0
) -> np.ndarray:
    """Apply the emulated channel: delay, attenuation, AWGN."""
    rng = np.random.default_rng(seed)
    rx = np.zeros_like(tx)
    d = spec.delay_samples
    gain = 10.0 ** (-spec.attenuation_db / 20.0)
    if d < len(tx):
        rx[d:] = tx[: len(tx) - d] * gain
    rx += spec.noise_std * (
        rng.standard_normal(len(tx)) + 1j * rng.standard_normal(len(tx))
    ).astype(np.complex64) / np.sqrt(2)
    return rx.astype(np.complex64)


def run_txrx(
    spec: TxRxSpec,
    out_dir: str,
    start_epoch: float = 0.0,
    bit_width: int = 12,
    seed: int = 0,
) -> Tuple[str, str]:
    """Run the loopback and write ``tx_*.iq`` / ``rx_*.iq``.

    The reference writes both sides the same way
    (``tx_rx_pulses_usrp.cpp:238-243, :287-292``).  Returns (tx_path,
    rx_path).
    """
    os.makedirs(out_dir, exist_ok=True)
    tx = tx_waveform(spec)
    rx = loopback(tx, spec, seed=seed)

    paths = []
    for prefix, stream in (("tx", tx), ("rx", rx)):
        # scale into the quantizer range: TX at 0.9 full scale like a
        # transmit amplitude below clipping
        scaled = stream * 0.9 if prefix == "tx" else stream
        samples = iqpacket.from_complex(scaled, bit_width)
        hdr = iqpacket.IqHeader(
            frequency_hz=spec.frequency_hz,
            bandwidth_hz=spec.sample_rate_sps,
            sample_rate_sps=spec.sample_rate_sps,
            rx_gain_db=0.0,
            num_samples=len(stream),
            bit_width=bit_width,
            sample_start_time=start_epoch,
            board_name="emulated",
            serial_number="loopback",
        )
        name = f"{prefix}_{iqpacket.utc_filename(start_epoch)}"
        path = os.path.join(out_dir, name)
        iqpacket.write_iq(path, hdr, samples)
        paths.append(path)
    return paths[0], paths[1]


def matched_filter_delay(
    tx: np.ndarray, rx: np.ndarray, max_lag: Optional[int] = None
) -> int:
    """Estimate the channel delay by cross-correlation (the loopback check)."""
    n = min(len(tx), len(rx))
    if max_lag is None:
        max_lag = n // 2
    f_tx = np.fft.fft(tx[:n])
    f_rx = np.fft.fft(rx[:n])
    xc = np.fft.ifft(f_rx * np.conj(f_tx))
    return int(np.argmax(np.abs(xc[:max_lag])))
