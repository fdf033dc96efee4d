"""MAS microbenchmark (the JAX package's `scripts/bench_mas.py`): the
plain version (the counterpart of JAX's `lax.scan` wavefront) against the
CUDA kernels, two-pass (`mas_fwd` + `mas_bwd`) and fused (`mas_fused`,
where its shared memory fits a block, as JAX checks its VMEM budget), at
JAX's four shapes, the flagship train shape [64, 400, 200] among them,
on JAX's problems (`numpy.random.RandomState(0)`). Prints ONE JSON line.

    python -m mb_istft_vits_torch.bench_mas [--n 20] [--reps 5] \
        [--device cpu]

On the card each route reports `kernel_ms`, the device time of one call
(a burst of `--n` calls queued behind a device sleep, CUDA events, median
of `--reps` bursts), and every route's path must equal the plain one. The
kernels' bound is the least time of their work (`bounds_ms`). On the CPU
only the plain route runs, and every time is null.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Sequence, Tuple

import numpy as np
import torch

from mb_istft_vits_torch.ops import mas
from mb_istft_vits_torch.utils import timing

SHAPES = [(64, 400, 200), (32, 400, 200), (64, 800, 380), (8, 1000, 380)]
ROUTES = ("plain", "two_pass", "fused")
DEVICE_FIELDS = ("rows.*.plain.kernel_ms", "rows.*.two_pass.kernel_ms")


def problems(shapes: Sequence[Tuple[int, int, int]] = SHAPES):
    """JAX's problems, drawn in its order from one RandomState(0): per
    shape (neg_cent f32, mask f32) numpy arrays [B, T_y, T_x]."""
    rng = np.random.RandomState(0)
    out = []
    for b, t_y, t_x in shapes:
        nc = rng.randn(b, t_y, t_x).astype(np.float32)
        t_ys = rng.randint(t_y // 2, t_y + 1, b)
        t_xs = rng.randint(t_x // 2, t_x + 1, b)
        mask = ((np.arange(t_y)[None, :, None] < t_ys[:, None, None])
                & (np.arange(t_x)[None, None, :] < t_xs[:, None, None]))
        out.append((nc, mask.astype(np.float32)))
    return out


def band_cells(t_ys, t_xs) -> int:
    """DP cells inside every item's band: the cells of neg_cent the DP
    needs, max(0, t_x + y - t_y) <= x < min(t_x, y + 1) for y < t_y."""
    total = 0
    for t_y, t_x in zip(t_ys, t_xs):
        for y in range(t_y):
            total += max(0, min(t_x, y + 1) - max(0, t_x + y - t_y))
    return total


def bounds_ms(b, t_y_max, t_x_max, t_ys, t_xs):
    """Least time for each kernel's work: bytes each input is read once
    and each output written once (data-dependent parts counted for these
    lengths) over HBM bandwidth, vs ~4 float ops per band cell over the
    float32 peak. Returns {kernel: (bound_ms, bound_by)}."""
    cells = band_cells(t_ys, t_xs)
    words = (t_x_max + 31) // 32
    path_bytes = 4 * b * t_y_max * t_x_max
    len_bytes = 8 * b
    by_kernel = {
        "mas_fused": 4 * cells + path_bytes + len_bytes,
        "mas_fwd": 4 * cells + 4 * words * sum(t_ys) + len_bytes,
        # the backtrack needs one decision word per emitted row
        "mas_bwd": 4 * sum(t_ys) + path_bytes + len_bytes,
    }
    ops = {"mas_fused": 4 * cells, "mas_fwd": 4 * cells, "mas_bwd": 0}
    out = {}
    for name, nbytes in by_kernel.items():
        t_bytes = nbytes / timing.HBM_BYTES_PER_S * 1e3
        t_ops = ops[name] / timing.PEAK_OPS_PER_S["float32"] * 1e3
        out[name] = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
    return out


def route_bounds(bounds) -> dict:
    """The bound of each route: two-pass is mas_fwd then mas_bwd."""
    fwd, bwd, fused = bounds["mas_fwd"], bounds["mas_bwd"], bounds["mas_fused"]
    return {"two_pass": fwd[0] + bwd[0], "fused": fused[0]}


def bench_shape(nc, mask, args, device) -> dict:
    b, t_y, t_x = nc.shape
    neg_cent = torch.from_numpy(nc).to(device)
    m = torch.from_numpy(mask).to(device)
    plain = mas.maximum_path(neg_cent, m, False)
    row = {"shape": [b, t_y, t_x],
           "plain": {"kernel_ms": timing.card_ms(
               lambda: mas.maximum_path(neg_cent, m, False), device,
               args.n, args.reps)}}
    if device.type != "cuda":
        return {**row, "two_pass": {"kernel_ms": None}}
    t_ys, t_xs = (t.tolist() for t in mas.mas_lengths(m))
    bounds = route_bounds(bounds_ms(b, t_y, t_x, t_ys, t_xs))
    fits = mas.fused_fits(t_y, t_x, device)
    for route in ROUTES[1:]:
        if route == "fused" and not fits:
            row[route] = {"fits": False}
            continue

        def call(route=route):
            return mas.maximum_path(neg_cent, m, True, force=route)

        ms = timing.kernel_time_ms(call, args.n, args.reps)
        row[route] = {"kernel_ms": ms, "bound_ms": bounds[route],
                      "speedup_vs_plain": row["plain"]["kernel_ms"] / ms,
                      "equals_plain": bool(torch.equal(call(), plain))}
    return row


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=20)
    p.add_argument("--reps", type=int, default=5)
    timing.add_device_argument(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = timing.tool_device(args.device)
    rows: List[dict] = [bench_shape(nc, mask, args, device)
                        for nc, mask in problems()]
    bad = [r["shape"] for r in rows for route in ROUTES[1:]
           if not r.get(route, {}).get("equals_plain", True)]
    if bad:
        raise AssertionError(f"MAS kernels differ from the plain version "
                             f"at {bad}")
    timing.emit({"metric": "mas_routes", "n": args.n, "reps": args.reps,
                 "rows": rows}, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
