"""Op-level device profile of the train step, or of the serving infer
program (the JAX package's `scripts/profile_step.py`): torch.profiler
around `--steps` steady steps writes a Chrome trace under `--logdir`,
then the trace's device events (kernels, copies, memsets) give the
device time by op category and the top `--top-k` kernels, and their
busy share: the union of their intervals over the trace's window (at
most 1; `device_overlap_ms` is the summed time less the union). Prints
ONE JSON line.

    python -m mb_istft_vits_torch.profile_step [--batch 32] [--steps 5] \
        [--bf16] [--infer] [--top-k 40] [--logdir DIR] [--device cpu]
    python -m mb_istft_vits_torch.profile_step --parse-only DIR

`--parse-only` re-reads the newest `*.pt.trace.json` under DIR (it
stands in for the JAX script's `xplane.pb`, which needs TensorFlow). The
batch is the JAX script's: device-spec int16 audio from RandomState(0),
every row full length. The steps are `train_step`'s, on a card the
replays of the step's CUDA graph (the warm-up steps and the capture run
before the trace). Trailing steps end the trace (`timing.run_trailing`),
and the parse cuts them off with everything after them: the profiler has
dropped the device records of a trace's last graph replays.
On the CPU the trace holds no device event and every device field is
null.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import tempfile

import numpy as np
import torch

from mb_istft_vits_torch.bench import CONFIG, TEXT, serving_module
from mb_istft_vits_torch.bench_train import load_config
from mb_istft_vits_torch.utils import timing

DEVICE_FIELDS = ("device_ms", "device_busy_ms", "device_busy_share")
# (category, pattern of a device event's name), first match wins
CATEGORIES = (
    ("mas", timing.MAS_KERNEL),
    ("copy/memset", r"^(memcpy|memset)|\bcopy_kernel|\bMemcpy|\bMemset"),
    ("conv dgrad", r"dgrad"),
    ("conv wgrad", r"wgrad"),
    ("conv fprop", r"fprop|conv|winograd|implicit_gemm|implicit_convolve"),
    # cuFFT's kernels, and cuDNN's FFT convolutions' transforms and
    # complex GEMMs
    ("fft", r"fft|region_transform|cf32"),
    ("gemm", r"gemm|gemv|cutlass|cublas|xmma"),
    ("element-wise/reduce", r"elementwise|reduce|softmax|index|cat_|"
                            r"foreach|multi_tensor|norm|scatter|gather|"
                            r"fill|where|compare|pointwise|unroll"),
)


def category(name: str, cat: str) -> str:
    if cat.lower() in ("gpu_memcpy", "gpu_memset"):
        return "copy/memset"
    for label, pattern in CATEGORIES:
        if re.search(pattern, name, re.IGNORECASE):
            return label
    return "other"


def newest_trace(logdir: str) -> str:
    paths = glob.glob(os.path.join(logdir, "**", "*.pt.trace.json"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no *.pt.trace.json under {logdir}")
    return max(paths, key=os.path.getmtime)


def parse_trace(path: str, top_k: int = 40) -> dict:
    """Device time by category and by kernel of a Chrome trace, with the
    busy share of its window."""
    events, window_us = timing.trace_device_events(path)
    activity = timing.device_activity(
        (e["ts"], e["ts"] + e["dur"], e["stream"], e["name"]) for e in events)
    by_cat = collections.Counter()
    by_name = collections.Counter()
    calls = collections.Counter()
    for e in events:
        by_cat[category(e["name"], e["cat"])] += e["dur"] / 1e3
        by_name[e["name"]] += e["dur"] / 1e3
        calls[e["name"]] += 1
    total = activity["device_ms"] or None
    return {"trace": path, "window_ms": window_us / 1e3,
            **timing.busy_fields(activity, window_us / 1e3),
            "device_events": len(events),
            "by_category": [{"name": k, "ms": v, "share": v / total}
                            for k, v in by_cat.most_common()] if total else [],
            "top_kernels": [{"name": k[:120], "ms": v, "share": v / total,
                             "calls": calls[k]}
                            for k, v in by_name.most_common(top_k)]
            if total else []}


def train_work(args, device):
    """One steady train step on the JAX script's batch: (warmed state's
    step function)."""
    from mb_istft_vits_torch.train.step import create_train_state, train_step

    cfg = load_config(args.config, args.batch, args.bf16)
    b, t_x, t_spec, d = args.batch, args.text_len, args.spec_frames, cfg.data
    rng = np.random.RandomState(0)
    wav_len = t_spec * d.hop_length + (d.filter_length - d.hop_length)
    host = {
        "x": rng.randint(1, cfg.model.n_vocab, (b, t_x)).astype(np.int32),
        "x_lengths": np.full(b, t_x, np.int32),
        "wav": (rng.randn(b, wav_len, 1) * 3000).astype(np.int16),
        "spec_lengths": np.full(b, t_spec, np.int32),
    }
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    state = create_train_state(cfg, device, seed=0)
    return lambda: train_step(state, batch)["loss/g/total"]


def infer_work(args, device):
    """The serving infer program of the headline sentence at its frame
    bucket."""
    from mb_istft_vits_torch.bench import headline, infer_call

    module = serving_module(args.config, device)
    _, bucket, _ = headline(module)
    return infer_call(module, TEXT, bucket)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parse-only", metavar="LOGDIR")
    p.add_argument("--logdir",
                   default=os.path.join(tempfile.gettempdir(), "torchprof"))
    p.add_argument("--config", default=CONFIG)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--spec-frames", type=int, default=400)
    p.add_argument("--text-len", type=int, default=192)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--infer", action="store_true",
                   help="profile the serving infer program instead")
    p.add_argument("--top-k", type=int, default=40)
    timing.add_device_argument(p)
    return p


def main(argv=None) -> int:
    from mb_istft_vits_torch.infer.graphs import WARMUP_ITERS
    from mb_istft_vits_torch.utils.observability import profile_trace

    args = build_parser().parse_args(argv)
    if args.parse_only:
        # a re-read: the trace does not say where it was recorded
        print(json.dumps({"metric": "profile_trace", **parse_trace(
            newest_trace(args.parse_only), args.top_k), "device": None}),
            flush=True)
        return 0
    device = timing.tool_device(args.device)
    work = (infer_work if args.infer else train_work)(args, device)
    # warm: first-shape set-up, and the step's warm-up steps and capture,
    # stay out of the trace
    for _ in range(1 if args.infer else WARMUP_ITERS + 1):
        work()
    timing.sync(device)
    os.makedirs(args.logdir, exist_ok=True)
    with profile_trace(args.logdir):
        for _ in range(args.steps):
            out = work()
        float(out.float().sum())  # ends in a device sync
        timing.run_trailing(lambda: float(work().float().sum()))
    report = parse_trace(newest_trace(args.logdir), args.top_k)
    timing.emit({"metric": "profile_infer" if args.infer else "profile_step",
                 "steps": args.steps, "batch": None if args.infer
                 else args.batch, **report}, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
