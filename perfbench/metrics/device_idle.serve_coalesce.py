"""The share of the traced window, in %, in which the device is idle and
the micro-batcher's worker is coalescing (a `serve.coalesce` span open:
from seeing a first request to taking the group)."""

from perfbench import spans


def read(ctx, result, trace):
    return spans.idle_while_open(trace, "serve.coalesce")
