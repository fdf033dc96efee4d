"""Rank 0's exposed collective time a step, in ms: the device time of its
NCCL kernels that no other kernel of the card overlaps (the card runs
only the collective, or waits inside it for the other ranks), summed over
a step's collectives and taken as the median over the window's steps.
The program's `train.collective` spans (each collective between two stage
graphs, from its launch to its return on the host) give the collectives
a step holds: a program that records none reports nothing."""

import re
import statistics

from perfbench import spans
from perfbench.yardstick.trace import merge

NCCL = re.compile("nccl", re.IGNORECASE)


def _uncovered(s, e, busy) -> int:
    """Nanoseconds of [s, e) that the sorted disjoint intervals `busy`
    leave open."""
    left = e - s
    for bs, be in busy:
        if be <= s:
            continue
        if bs >= e:
            break
        left -= min(be, e) - max(bs, s)
    return left


def read(ctx, result, trace):
    got = spans.window_spans(trace)
    collectives = [1 for n, *_ in got or () if n == "train.collective"]
    steps = result["counters"].get("steps")
    if not collectives or not steps:
        return None
    per_step = max(1, round(len(collectives) / steps))
    device = trace.in_window(trace.device)
    nccl = sorted((s, e) for s, e, name in device if NCCL.search(name))
    busy = merge((s, e) for s, e, name in device if not NCCL.search(name))
    if not nccl:
        return None
    exposed = [_uncovered(s, e, busy) for s, e in nccl]
    by_step = [sum(exposed[i:i + per_step])
               for i in range(0, len(exposed) - per_step + 1, per_step)]
    return statistics.median(by_step) / 1e6
