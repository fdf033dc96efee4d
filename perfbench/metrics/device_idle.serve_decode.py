"""The share of the traced window, in %, in which the device is idle
while the micro-batcher's worker holds a group (a `serve.decode` span
open: from taking the group to every answer set): the card waiting on
the host with work in hand."""

from perfbench import spans


def read(ctx, result, trace):
    return spans.idle_while_open(trace, "serve.decode")
