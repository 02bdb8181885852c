"""The device trace of a ``--trace 1`` window, read from ``torch.profiler``
(CUPTI on the card): every device activity (kernels, copies, fills) with
its start and end, and the harness's own spans (``record_function``
ranges named ``chanbench.<span>``) on the same clock."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

PREFIX = "chanbench."

Interval = Tuple[str, int, int]     # name, start ns, end ns


@dataclasses.dataclass
class Trace:
    device: List[Interval]          # device activities, by start
    spans: List[Interval]           # harness spans (name without PREFIX)
    window: Tuple[int, int]         # the traced window, ns

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def _clipped(self, kinds=None) -> List[Tuple[int, int]]:
        lo, hi = self.window
        return [(max(s, lo), min(e, hi)) for name, s, e in self.device
                if e > lo and s < hi
                and (kinds is None or kind(name) in kinds)]

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device's activities in the window."""
        merged: List[List[int]] = []
        for s, e in sorted(self._clipped()):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-9

    def seconds(self, *kinds: str) -> float:
        """Summed device time of the activities of ``kinds``."""
        return sum(e - s for s, e in self._clipped(set(kinds))) * 1e-9

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, int] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0) + (e - s)
        return [[k, v * 1e-9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time in the window, summed by the innermost
        harness span open at each gap's middle (``loop`` outside any)."""
        lo, hi = self.window
        edges = [lo] + [t for iv in self.busy() for t in iv] + [hi]
        by: Dict[str, int] = {}
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) // 2
            inner = [(ss, name) for name, ss, ee in self.spans
                     if ss <= mid < ee and name != "window"]
            name = max(inner)[1] if inner else "loop"
            by[name] = by.get(name, 0) + (e - s)
        return [[k, v * 1e-9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def kind(name: str) -> str:
    """``htod``, ``dtoh``, ``dtod``, ``memset`` or ``kernel``."""
    low = name.lower()
    if low.startswith("memcpy"):
        for k in ("htod", "dtoh", "dtod"):
            if k in low:
                return k
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def start():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def stop(prof) -> Trace:
    """End the profile and read it: device activities and the spans."""
    from torch.autograd import DeviceType

    prof.__exit__(None, None, None)
    device, spans = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        act = str(ev.activity_type()).lower() if hasattr(
            ev, "activity_type") else ""
        if ev.device_type() == DeviceType.CPU:
            if name.startswith(PREFIX):
                spans.append((name[len(PREFIX):], s, e))
        elif not name.startswith(PREFIX) and "annotation" not in act:
            device.append((name, s, e))
    device.sort(key=lambda iv: iv[1])
    win = [(s, e) for name, s, e in spans if name == "window"]
    if not win:
        raise RuntimeError("the trace holds no window span")
    return Trace(device, spans, win[0])
