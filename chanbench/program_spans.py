"""The program's own spans and counters (``utils.profiling``'s recorder),
read by the per-layer metrics of its layers.  A reader's ``install``
turns the recorder on for the traced window under the harness's prefix,
so that the program's ranges reach the device trace beside the harness's
spans and ``breakdown.idle_gaps`` names a gap by the innermost program span
open across it.  A program without the recorder gives nothing to read."""

import importlib
from typing import Optional

from chanbench import harness


def _recorder():
    try:
        mod = importlib.import_module(
            "sdr_channelizer_tpu_torch.utils.profiling")
    except ImportError:
        return None
    return mod if hasattr(mod, "enable") and hasattr(mod, "snapshot") \
        else None


def install(run) -> None:
    rec = _recorder()
    if rec is not None:
        rec.enable(prefix=harness.SPAN_PREFIX)


def recorded() -> Optional[dict]:
    """The recorder's snapshot: spans by name and counters."""
    rec = _recorder()
    return None if rec is None else rec.snapshot()


def self_ms(res, *names: str) -> Optional[float]:
    """The spans ``names``' self time, ms a capture; None where none of
    them was recorded."""
    snap = recorded()
    spans = [snap["spans"][n] for n in names
             if snap is not None and n in snap["spans"]]
    if not spans or not res.captures:
        return None
    return sum(s["self_s"] for s in spans) / res.captures * 1e3
