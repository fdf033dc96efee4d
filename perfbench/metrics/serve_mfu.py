"""The whole model's share, in %, of the card's float32 peak in the
traced window: the benchmark's count of the operations of every row the
serving module decoded in the window at its real ids and frames
(`yardstick/flops_serve.py`: text encoder, duration predictor, the
prior's expansion, the flow's reverse, the decoder head), from its
`synth.frames` counts, over the window's seconds times the float32 peak
(`yardstick/stats.py`)."""

from perfbench.counts import window_counts
from perfbench.yardstick.flops_serve import request_flops
from perfbench.yardstick.stats import PEAK_OPS_PER_S


def read(ctx, result, trace):
    decodes = window_counts(trace, "synth.frames")
    if not decodes or trace.window_s <= 0:
        return None
    total = sum(request_flops(ctx.config, t_x, t_y)
                for _, _, frames, ids in decodes
                for t_y, t_x in zip(frames, ids))
    return 100.0 * total / (trace.window_s * PEAK_OPS_PER_S["float32"])
