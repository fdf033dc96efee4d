"""The traced run's window: `torch.profiler` over the measured window and
a few trailing steps, and the arithmetic that reads it.

The window is the host range "perfbench.window"; the driver runs a few
more steps after it in the range "perfbench.trailing", because the
profiler can lose the device events of the last graph replays before it
stops, and every device event that starts at or after that range is
dropped. Busy time is the union of the device intervals (kernels,
copies, memsets) inside the window, so overlapping streams count once."""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

WINDOW, TRAILING = "perfbench.window", "perfbench.trailing"
Interval = Tuple[int, int, str]


class Tracer:
    """Profiles from `__enter__` to `__exit__` when enabled; a no-op
    otherwise. `window()` and `trailing()` mark the ranges."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.data: Optional[TraceData] = None

    def __enter__(self):
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.data = TraceData.from_events(
                    self.prof.profiler.kineto_results.events())
        return False

    def range(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def window(self):
        return self.range(WINDOW)

    def trailing(self):
        return self.range(TRAILING)


def merge(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals, as disjoint sorted intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: Iterable[Tuple[int, int]], t0: int, t1: int) -> int:
    """Nanoseconds of [t0, t1) that the intervals cover, overlaps once."""
    clipped = [(max(s, t0), min(e, t1)) for s, e in intervals
               if e > t0 and s < t1]
    return sum(e - s for s, e in merge(clipped))


@dataclass
class TraceData:
    t0: int = 0
    t1: int = 0
    device: List[Interval] = field(default_factory=list)
    host: List[Interval] = field(default_factory=list)

    @classmethod
    def from_events(cls, events) -> "TraceData":
        device, host = [], []
        t0 = t1 = cut = None
        for ev in events:
            s, e, name = ev.start_ns(), ev.end_ns(), ev.name()
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                # the device rows of host ranges span their kernels' gaps
                if not ev.is_user_annotation():
                    device.append((s, e, name))
                continue
            host.append((s, e, name))
            if name == WINDOW:
                t0, t1 = s, e
            elif name == TRAILING:
                cut = s if cut is None else min(cut, s)
        if t0 is None:
            raise RuntimeError("the trace holds no window range")
        if cut is not None:
            device = [d for d in device if d[0] < cut]
        return cls(t0, t1, sorted(device), sorted(host))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def in_window(self, events: Sequence[Interval]) -> List[Interval]:
        return [ev for ev in events if ev[1] > self.t0 and ev[0] < self.t1]

    def busy_s(self) -> float:
        return covered(((s, e) for s, e, _ in self.device), self.t0,
                       self.t1) / 1e9

    def top_device_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for s, e, name in self.in_window(self.device):
            by[name] = by.get(name, 0.0) + (min(e, self.t1)
                                            - max(s, self.t0)) / 1e9
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, longest: int = 500) -> List[list]:
        """The device's idle gaps in the window, the `longest` of them
        named by the innermost host range running when each began,
        summed by name: the n largest."""
        busy = merge((max(s, self.t0), min(e, self.t1))
                     for s, e, _ in self.in_window(self.device))
        gaps, at = [], self.t0
        for s, e in busy:
            if s > at:
                gaps.append((s - at, at))
            at = max(at, e)
        if self.t1 > at:
            gaps.append((self.t1 - at, at))
        gaps = sorted(gaps, reverse=True)[:longest]
        host = [h for h in self.host if h[2] != WINDOW]
        starts = [h[0] for h in host]
        by: Dict[str, float] = {}
        for length, begin in gaps:
            # the latest-starting host range still open at `begin`
            last = bisect.bisect_right(starts, begin) - 1
            name = next((host[i][2] for i in range(last, max(-1, last - 2000),
                                                     -1)
                         if host[i][1] > begin), "idle")
            by[name] = by.get(name, 0.0) + length / 1e9
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]
