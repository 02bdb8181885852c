"""The one traffic generator: a mix's data file in, a pool of dwells out.

A mix (``traffic/<mix>.json``) names emitters by law, not by code:

* ``pool``: distinct items the window cycles through; ``files_per_item``
  dwells to an item (a streamed segment), 1 by default;
* ``noise_std``: the standard deviation of each of I and Q, full scale 1;
* ``emitters``: each ``count`` times a dwell, with ``freq_hz``, ``pw_s``,
  ``pri_s`` and ``amplitude`` (or ``snr_db`` over the complex noise's rms),
  each a number or ``{"uniform": [lo, hi]}``, which may name another key
  under ``"at_least"`` (the upstream's PRI >= PW);
* ``law``: optional, another generator, ``laws/<law>.py``, found by name,
  whose ``make_pool`` takes this module's place (it may reuse ``synth``,
  ``quantise``, ``write_iq_v3`` and ``Item`` from here).

Each uniform is drawn over the pool's emitters as a Latin hypercube, so that
every seed gets the same spread of widths and rates in another order and the
work of a pool hardly depends on the seed.  Every emitter starts at a sample drawn uniformly within one PRI and repeats
every PRI; a pulse is written only where it ends before the dwell does
(``generate_training_iq.m:52-55``), each with the same phase profile from a
start phase drawn per emitter.  The scalars come from NumPy's generator on
the seed, the noise and the dwell from one ``torch.Generator`` on the
device, in a few large calls; the payload is quantised as the recorder
writes it (round half away from zero, saturate) to the configuration's
``payload_dtype`` and handed over as an ordinary pageable (N, 2) NumPy
array.
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
from typing import List, Optional

import numpy as np
import torch

_KEYS = ("freq_hz", "pw_s", "pri_s", "amplitude", "snr_db")
# a segment's files start this many seconds apart from the next segment's
_SEGMENT_SPACING_S = 1000.0


@dataclasses.dataclass
class Emitter:
    freq_hz: float
    pw: int        # samples
    pri: int       # samples
    start: int     # 0-based sample of the first pulse
    amplitude: float
    phase: float   # radians


@dataclasses.dataclass
class Item:
    """One unit of work: the raw payload of each of its dwells, their
    start times, and the files they were written to (streamed mixes)."""

    payloads: List[np.ndarray]
    start_times: List[float]
    paths: Optional[List[str]] = None

    @property
    def samples(self) -> int:
        return sum(p.shape[0] for p in self.payloads)


def _unit_draws(n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` uniforms in [0, 1), one in each of ``n`` equal strata."""
    return (rng.permutation(n) + rng.random(n)) / n


def payload_dtype(cfg: dict) -> np.dtype:
    """The configuration's ``payload_dtype``, which the ``.iq`` format ties
    to the bit width: int8 up to 8 bits, int16 up to 16."""
    dt = np.dtype(cfg["payload_dtype"])
    bits = int(cfg["bit_width"])
    want = (np.dtype(np.int8) if 0 < bits <= 8 else
            np.dtype(np.int16) if 8 < bits <= 16 else None)
    if dt != want:
        raise ValueError(f"payload_dtype {dt} does not hold {bits}-bit "
                         f"samples as the recorder writes them ({want})")
    return dt


def draw_emitters(mix: dict, n_dwells: int, fs: float,
                  rng: np.random.Generator) -> List[List[Emitter]]:
    """Each dwell's emitters, drawn from ``rng`` by the mix's laws."""
    dwells: List[List[Emitter]] = [[] for _ in range(n_dwells)]
    for spec in mix["emitters"]:
        unknown = set(spec) - set(_KEYS) - {"count"}
        if unknown:
            raise ValueError(f"unknown emitter keys {sorted(unknown)}")
        n = n_dwells * int(spec.get("count", 1))
        vals = {}
        for key in _KEYS:
            law = spec.get(key)
            if law is None:
                continue
            if isinstance(law, dict):
                lo, hi = (float(v) for v in law["uniform"])
                lo = np.full(n, lo)
                if "at_least" in law:
                    lo = np.maximum(lo, vals[law["at_least"]])
                vals[key] = lo + (hi - lo) * _unit_draws(n, rng)
            else:
                vals[key] = np.full(n, float(law))
        if ("amplitude" in vals) == ("snr_db" in vals):
            raise ValueError("an emitter takes amplitude or snr_db")
        amp = vals.get("amplitude")
        if amp is None:
            rms = float(mix["noise_std"]) * math.sqrt(2.0)
            amp = rms * 10.0 ** (vals["snr_db"] / 20.0)
        pw = np.maximum(np.rint(vals["pw_s"] * fs).astype(np.int64), 1)
        pri = np.maximum(np.rint(vals["pri_s"] * fs).astype(np.int64), 1)
        start = (rng.random(n) * pri).astype(np.int64)
        phase = rng.random(n) * 2.0 * math.pi
        for i in range(n):
            dwells[i % n_dwells].append(Emitter(
                float(vals["freq_hz"][i]), int(pw[i]), int(pri[i]),
                int(start[i]), float(amp[i]), float(phase[i])))
    return dwells


def synth(n: int, fs: float, noise_std: float, emitters: List[Emitter],
          gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """One dwell on the device, (2, n) float32 I and Q at full scale 1:
    noise plus the emitters' pulses."""
    x = torch.randn((2, n), generator=gen, device=device,
                    dtype=torch.float32) * noise_std
    k = torch.arange(n, device=device, dtype=torch.int64)
    for e in emitters:
        if e.start + e.pw >= n:
            continue
        n_pulses = (n - e.pw - 1 - e.start) // e.pri + 1
        rel = k - e.start
        j = torch.div(rel, e.pri, rounding_mode="floor")
        within = rel - j * e.pri
        on = (rel >= 0) & (within < e.pw) & (j < n_pulses)
        ph = e.phase + (2.0 * math.pi * e.freq_hz / fs) * within.to(
            torch.float64)
        amp = torch.where(on, torch.full((), e.amplitude, dtype=torch.float64,
                                         device=device),
                          torch.zeros((), dtype=torch.float64, device=device))
        x[0] += (amp * torch.cos(ph)).to(torch.float32)
        x[1] += (amp * torch.sin(ph)).to(torch.float32)
        del rel, j, within, on, ph, amp
    return x


_TORCH_INT = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16}


def quantise(x: torch.Tensor, cfg: dict) -> np.ndarray:
    """(2, n) float I and Q -> the recorder's (n, 2) payload in the
    configuration's type and bit width, on the host."""
    dt = payload_dtype(cfg)
    scale = float(2 ** (int(cfg["bit_width"]) - 1))
    q = torch.sign(x) * torch.floor(x.abs() * scale + 0.5)
    q = q.clamp(-scale, scale - 1).to(_TORCH_INT[dt])
    return q.T.contiguous().cpu().numpy()


def write_iq_v3(path: str, payload: np.ndarray, fs: float, fc: float,
                bit_width: int, start_time: float) -> None:
    """An IqPacket v3 file (``cpp/IqPacket.h``): the 112-byte little-endian
    header, then the interleaved payload in its own type."""
    head = struct.pack(
        "<IIQIIfIII16s16s16s16sd", 0x03030303, 1, int(fc), int(fs), int(fs),
        0.0, payload.shape[0], bit_width, 0, b"chanbench", b"", b"", b"",
        start_time)
    with open(path, "wb") as f:
        f.write(head)
        f.write(np.ascontiguousarray(payload, payload.dtype.newbyteorder("<")).tobytes())


def make_pool(mix: dict, cfg: dict, seed: int, device: torch.device,
              out_dir: Optional[str] = None) -> List[Item]:
    """The mix's pool for ``seed``: ``pool`` items of ``files_per_item``
    dwells of ``cfg["dwell_samples"]`` samples each; with ``out_dir`` every
    dwell is also written there as an ``.iq`` v3 file, the files of an item
    contiguous in time."""
    seed = int(seed) % (1 << 63)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    fs = float(cfg["sample_rate_sps"])
    n = int(cfg["dwell_samples"])
    per_item = int(mix.get("files_per_item", 1))
    n_items = int(mix["pool"])
    dwells = draw_emitters(mix, n_items * per_item, fs, rng)
    items = []
    for i in range(n_items):
        payloads, starts, paths = [], [], []
        for j in range(per_item):
            x = synth(n, fs, float(mix["noise_std"]), dwells[i * per_item + j],
                      gen, device)
            payloads.append(quantise(x, cfg))
            del x
            starts.append(i * _SEGMENT_SPACING_S + j * n / fs)
            if out_dir is not None:
                paths.append(os.path.join(out_dir, f"item{i:03d}_{j:02d}.iq"))
                write_iq_v3(paths[-1], payloads[-1], fs,
                            float(cfg["center_frequency_hz"]),
                            int(cfg["bit_width"]), starts[-1])
        items.append(Item(payloads, starts, paths if out_dir else None))
    return items
