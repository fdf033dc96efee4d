#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the
card: for each seed, the program's numbers against the plain reference
and the control's, the reference computed one precision lower (TF32,
where the configuration states float32 with TF32 off) put in the
program's place.

    python3 perfbench/controls.py --workload <cell> --seeds <n> [<n> ...]
        [--seconds <s>] [--control-seeds <k>] [--sample <k>]

A training cell needs no window: each seed builds the cell's one
training state, runs its checked steps and the reference, and (for the
first `--control-seeds` seeds) the reference again in TF32. A serving
cell runs its traffic for `--seconds` at the cell's rate (set-up
included) and compares the control on the same sample of requests;
`--sample` sets the sample's size in place of the cell's (a size above
the requests answered judges every one of them).
Prints one JSON line a seed; the benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from perfbench import run as harness  # noqa: E402
from perfbench.reference.precision import float32, tf32  # noqa: E402
from perfbench.yardstick import compare  # noqa: E402


def _detail(prog, ref):
    """Each step's loss terms' gaps and the worst leaves, for reading a
    gap."""
    out = {key: [compare.term_gaps(p, r) for p, r in zip(prog[key],
                                                          ref[key])]
           for key in ("losses", "replays") if key in ref}
    for key in ("grad_norms", "change_norms"):
        med = sorted(ref[key].values())[len(ref[key]) // 2]
        gaps = {k: abs(prog[key][k] - v) / max(v, med)
                for k, v in ref[key].items() if k in prog[key]}
        out[key] = sorted(gaps.items(), key=lambda kv: -kv[1])[:4]
    out["grad_gap_all_leaves"] = compare.leaf_gap(prog["grad_norms"],
                                                  ref["grad_norms"])
    return out


def train_readings(ctx, control: bool):
    from perfbench.drivers.train import TrainRun

    tr = TrainRun(ctx)
    prog = tr.first_steps()
    prog["replays"] = tr.warm()
    tr.free()
    with float32():
        ref = tr.reference()
    out = {"program": compare.train_numbers(prog, ref),
           "program_detail": _detail(prog, ref)}
    if control:
        with tf32():
            low = tr.reference()
        out["control"] = compare.train_numbers(low, ref)
        out["control_detail"] = _detail(low, ref)
        # the fault of half the batch left out, planted in the reference
        with float32():
            half = tr.reference(rows=tr.checked[0][0]["x"].shape[0] // 2)
        out["half_batch"] = compare.train_numbers(half, ref)
    return out


def serve_readings(ctx, control: bool):
    from perfbench.drivers import serve_open

    res = serve_open.run(ctx)
    out = {"program": res["numbers"], "failed": res["failed"],
           "p95_ms": res["end_to_end"]["serve_p95_ms"]}
    if control:
        out["control"] = serve_open.control_numbers(res, tf32)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--sample", type=int)
    args = p.parse_args(argv)
    for i, seed in enumerate(args.seeds):
        ctx = harness.context(args.workload, seed, args.seconds, False,
                              torch.device("cuda", 0))
        if args.sample:
            ctx.workload = dict(ctx.workload, sample=args.sample)
        kind = ctx.workload["driver"]
        read = train_readings if kind == "train" else serve_readings
        out = read(ctx, i < args.control_seeds)
        print(json.dumps({"seed": seed, **out}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
