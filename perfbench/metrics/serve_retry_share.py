"""Decodes redone at a larger frame bucket per hundred decodes in the
window: `synth.retry` spans over `serve.decode` spans, x100."""

from perfbench import spans


def read(ctx, result, trace):
    got = spans.window_spans(trace)
    decodes = spans.count(got or (), "serve.decode")
    if not decodes:
        return None
    return 100.0 * spans.count(got, "synth.retry") / decodes
