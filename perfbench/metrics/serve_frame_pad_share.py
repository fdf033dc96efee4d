"""The share, in %, of the window's decoded frames that are padding: the
frames of every decode's batch and frame buckets (rows x bucket) less
the real rows' frames, over the former, from the serving module's
`synth.frames` counts."""

from perfbench.counts import window_counts


def read(ctx, result, trace):
    decodes = window_counts(trace, "synth.frames")
    if not decodes:
        return None
    padded = sum(rows * bucket for rows, bucket, *_ in decodes)
    real = sum(sum(frames) for _, _, frames, _ in decodes)
    return 100.0 * (padded - real) / padded
