"""The program's counts in the traced window, for the metrics that read
them (beside `spans`, which reads its spans the same way).

The port logs a count (`mb_istft_vits_torch.utils.observability.
record_count`) while a profiler runs, stamped on the clock of the
profiler's host events. A program without that log, an untraced run, and
a log that holds none of the window's counts or dropped some give no
counts, and the metric then reports nothing."""

from __future__ import annotations

from typing import List, Optional


def window_counts(trace, name: str) -> Optional[List[tuple]]:
    """The values of the `name` counts stamped in the trace's window, or
    None."""
    if trace is None:
        return None
    try:
        from mb_istft_vits_torch.utils.observability import recorded_counts
    except ImportError:
        return None
    counts, dropped = recorded_counts(trace.t0, trace.t1)
    got = [v for n, _, v in counts if n == name]
    return got if got and not dropped else None
