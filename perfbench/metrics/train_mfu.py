"""The training step's share of the card's peak: the benchmark's own count
of the window's operations (`yardstick.flops`, each row at its real
lengths) over the window's seconds, over the peak of the precision the
process ran the step in (read at the window's end)."""

from perfbench.yardstick.stats import PEAK_OPS_PER_S


def read(ctx, result, trace):
    c = result["counters"]
    if "flops" not in c:
        return None
    return 100.0 * c["flops"] / c["window_s"] / PEAK_OPS_PER_S[c["precision"]]
