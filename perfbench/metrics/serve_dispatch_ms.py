"""The median of the host milliseconds the serving module spent queueing
a decode (its `dispatch` timing), over the window's lone-request decodes,
the only ones that report it."""

import statistics


def read(ctx, result, trace):
    values = result["counters"].get("dispatch_ms")
    return statistics.median(values) if values else None
