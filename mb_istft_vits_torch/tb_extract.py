"""Extract scalar trajectories from a run's tfevents into a table (the
JAX package's `scripts/tb_extract.py`; `tensorboard` is imported when it
runs, not with the module).

Usage:
  python -m mb_istft_vits_torch.tb_extract logs/<name> [tag ...]

With no tags, lists the available scalar tags. With tags, prints a
markdown table (step + one column per tag), sampling at most --max-rows
evenly spaced rows so a 200k-step run stays readable. Used to produce
the eval-metric trajectory tables in BENCH_NOTES.md (copy-synthesis
MCD/LSD/F0 over a training run — the reference's capability evidence is
TensorBoard curves from train_latest.py:299-305; this is the equivalent
readout of ours).
"""

import argparse
import glob
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("logdir")
    ap.add_argument("tags", nargs="*")
    ap.add_argument("--max-rows", type=int, default=24)
    args = ap.parse_args(argv)

    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    series = {}  # tag -> {step: value}
    for f in sorted(glob.glob(os.path.join(args.logdir,
                                           "events.out.tfevents.*"))):
        acc = EventAccumulator(f, size_guidance={"scalars": 0})
        acc.Reload()
        for tag in acc.Tags().get("scalars", []):
            d = series.setdefault(tag, {})
            for ev in acc.Scalars(tag):
                d[ev.step] = ev.value

    if not args.tags:
        for tag in sorted(series):
            steps = sorted(series[tag])
            print(f"{tag}  ({len(steps)} points, steps "
                  f"{steps[0]}..{steps[-1]})")
        return

    for t in args.tags:
        if t not in series:
            sys.exit(f"unknown tag {t!r}; available: {sorted(series)}")
    steps = sorted(set().union(*(series[t] for t in args.tags)))
    if len(steps) > args.max_rows:
        idx = [round(i * (len(steps) - 1) / (args.max_rows - 1))
               for i in range(args.max_rows)]
        steps = [steps[i] for i in sorted(set(idx))]
    print("| step | " + " | ".join(args.tags) + " |")
    print("|---" * (len(args.tags) + 1) + "|")
    for s in steps:
        row = [f"{series[t][s]:.3f}" if s in series[t] else ""
               for t in args.tags]
        print(f"| {s} | " + " | ".join(row) + " |")


if __name__ == "__main__":
    main()
