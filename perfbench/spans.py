"""The program's spans in the traced window, for the metrics that read
them (beside the yardstick, which imports nothing of the program).

The port records spans (`mb_istft_vits_torch.utils.observability`) while
a profiler runs, from any thread, on the clock of the profiler's host
events, so they lie on the trace's own time base. A program without that
recorder, an untraced run, and a log that is empty or dropped spans of
the window give no spans, and the metric then reports nothing."""

from __future__ import annotations

import statistics
from typing import List, Optional, Sequence, Tuple

from perfbench.yardstick.trace import merge

Span = Tuple[str, int, int, int]  # (name, thread, start ns, end ns)


def window_spans(trace) -> Optional[List[Span]]:
    """The spans that start in the trace's window, or None."""
    if trace is None:
        return None
    try:
        from mb_istft_vits_torch.utils.observability import recorded_spans
    except ImportError:
        return None
    spans, dropped = recorded_spans(trace.t0, trace.t1)
    return spans if spans and not dropped else None


def median_ms(trace, name: str) -> Optional[float]:
    """The median duration of the window's `name` spans, in ms."""
    spans = window_spans(trace)
    got = [(e - s) / 1e6 for n, _, s, e in spans or () if n == name]
    return statistics.median(got) if got else None


def count(spans: Sequence[Span], name: str) -> int:
    return sum(1 for n, *_ in spans if n == name)


def _overlap_ns(a, b) -> int:
    """Nanoseconds two sorted lists of disjoint intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_while_open(trace, name: str) -> Optional[float]:
    """The share of the window, in %, in which the device is idle (one
    minus the union of its intervals, as `device_idle.serve` reads it)
    and a `name` span is open."""
    spans = window_spans(trace)
    if spans is None or trace.t1 <= trace.t0:
        return None
    opened = merge((s, min(e, trace.t1)) for n, _, s, e in spans
                   if n == name)
    busy = merge((max(s, trace.t0), min(e, trace.t1))
                 for s, e, _ in trace.in_window(trace.device))
    idle = sum(e - s for s, e in opened) - _overlap_ns(opened, busy)
    return 100.0 * idle / (trace.t1 - trace.t0)
