"""The median of the window's `synth.dispatch` spans, in ms: the host
time queueing a decode's noise, graphs and copy back, over every decode,
lone and coalesced."""

from perfbench import spans


def read(ctx, result, trace):
    return spans.median_ms(trace, "synth.dispatch")
