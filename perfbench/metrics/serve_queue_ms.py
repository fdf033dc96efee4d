"""The median of the window's `serve.queued` spans, in ms: a request's
wait in the micro-batcher's queue, from its enqueue on the caller's
thread to the worker taking it into a group."""

from perfbench import spans


def read(ctx, result, trace):
    return spans.median_ms(trace, "serve.queued")
