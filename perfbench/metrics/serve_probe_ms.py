"""The median of the window's `synth.probe` spans, in ms: the duration
probe's round trip, from its launch to the frame bucket known on the
host."""

from perfbench import spans


def read(ctx, result, trace):
    return spans.median_ms(trace, "synth.probe")
