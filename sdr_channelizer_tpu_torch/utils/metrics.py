"""Structured counters — the framework's observability surface.

The reference reports overrun counts, received-sample counts, and
saturation events as free-form stdout (``blade_record_iq_12bit.cpp:29,307,
340``; ``blade_find_max_unsaturated_gain.cpp:270``).  Here the same signals
are named counters with a single JSON-able snapshot: samples ingested,
blocks processed/dropped, pulses emitted, saturation events, overruns.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict


@dataclasses.dataclass
class Counters:
    values: Dict[str, float] = dataclasses.field(default_factory=dict)
    started: float = dataclasses.field(default_factory=time.time)

    def add(self, name: str, amount: float = 1.0) -> None:
        self.values[name] = self.values.get(name, 0.0) + amount

    def set(self, name: str, value: float) -> None:
        self.values[name] = value

    def get(self, name: str) -> float:
        return self.values.get(name, 0.0)

    def rates(self) -> Dict[str, float]:
        """Per-second rates since construction (samples/s, pulses/s, ...)."""
        dt = max(time.time() - self.started, 1e-9)
        return {f"{k}_per_sec": v / dt for k, v in self.values.items()}

    def snapshot(self) -> dict:
        return {"counters": dict(self.values), "uptime_sec": time.time() - self.started}

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)
