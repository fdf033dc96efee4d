"""Training-step throughput of the flagship, synthetic batch (the JAX
package's `scripts/bench_train.py`): the first step, the D and G halves,
the step synced every time and queued, optionally fed from the host and
double-buffered, audio-seconds trained a second, and with `--flops` the
counted FLOPs a step, the achieved rate and `mfu`. Prints ONE JSON line.

    python -m mb_istft_vits_torch.bench_train [--batch 64] [--steps 10] \
        [--bf16] [--feed-host] [--device-spec] [--widen N] [--flops] \
        [--device cpu]
    torchrun --nproc_per_node N -m mb_istft_vits_torch.bench_train ...

Under torchrun (one rank a card; or in a process group already running)
the state is data-parallel (`parallel.shard_train_state_dp`) and
`--batch` is the global batch, split over the ranks as JAX's
`shard_batch` splits it over the mesh: rank r takes its rows of the
same synthetic batch. `devices` is the world; `step_ms`, `step_ms_host`
and `step_ms_sync` are the slowest rank's, gathered once at the end;
`flops_per_step` is the global batch's (the ranks' counts summed) and
`mfu` is it over `step_ms` x world x the peak. The other fields, and
the line, are rank 0's. Without a group it runs on one card.

Every step is `train/step.py`'s `train_step`, which on a card is what
the trainer runs: the step's CUDA graphs for the batch's signature
(`train/graphs.py`; a data-parallel rank's a graph a stage, with its
collectives between). `first_step_s` is the wall time of the steps up
to and including the first replay: the eager warm-up steps and the
capture (`first_steps` of them; one on the CPU). `graphs` (signatures
stepped at), `captures`, `capture_s` (their seconds) and `pool_bytes`
(the graphs' memory pool) follow it. `step_ms` is the card's time a
step: CUDA events before the first and after the last of `--steps`
queued steps (one sync at the end, as training runs), over the steps;
`step_ms_host` is the same run on the host clock, and `steps_per_s` and
`audio_s_per_s` are read from it, the rate a training run gets.
`step_ms_sync` (synced each step) and the feed's step times are
host-clock means too. The halves are CUDA events around D's backward and
update (`d_step_ms`), G's backward and update (`g_step_ms`), and the
batch prep and generator forward before them (`forward_ms`) of the eager
step (`train_step_eager`: a replay has no halves to time), medians over
`--steps` steps. `--flops` counts one eager step with
`torch.utils.flop_counter` (`utils.timing.count`, on the card; a replay
shows no op to it): `mfu` is the counted FLOPs over `step_ms`, divided
by the peak of the step's precision (`peak_for`: float32 with TF32 off,
as the trainer runs, or bf16 with `--bf16`). On the CPU every device
time, `capture_s`, `pool_bytes`, `achieved_tflops` and `mfu` is null.
`--no-donate` (XLA's buffer donation) is accepted and unused.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from mb_istft_vits_torch.bench import CONFIG
from mb_istft_vits_torch.utils import timing

DEVICE_FIELDS = ("forward_ms", "d_step_ms", "g_step_ms", "step_ms",
                 "capture_s", "pool_bytes", "achieved_tflops", "mfu")
WIDENED = ("inter_channels", "hidden_channels", "filter_channels",
           "upsample_initial_channel")


def load_config(path: str, batch: int = 0, bf16: bool = False,
                widen: int = 1):
    """The config at `path` with the JAX scripts' overrides: batch size
    (0 keeps the config's), bf16 (`fp16_run`), channel widths x `widen`."""
    from mb_istft_vits_torch.config import Config

    cfg = Config.from_json(path)
    if bf16:
        object.__setattr__(cfg.train, "fp16_run", True)
    if batch:
        object.__setattr__(cfg.train, "batch_size", batch)
    for f in WIDENED if widen > 1 else ():
        object.__setattr__(cfg.model, f, getattr(cfg.model, f) * widen)
    return cfg


def synthetic_batch(cfg, b: int, t_spec: int, t_x: int,
                    device_spec: bool) -> dict:
    """JAX's batch of numpy arrays, from RandomState(0), every row full
    length: random ids, a random spectrogram [B, T_spec, bins] and float
    audio of t_spec hops; `device_spec`: int16 audio with the STFT's tail
    and no spectrogram (the trainer computes it on the card)."""
    d = cfg.data
    rng = np.random.RandomState(0)
    batch = {
        "x": rng.randint(1, cfg.model.n_vocab, size=(b, t_x)).astype(np.int32),
        "x_lengths": np.full(b, t_x, np.int32),
        "spec": (rng.randn(b, t_spec, d.filter_length // 2 + 1) ** 2
                 ).astype(np.float32),
        "spec_lengths": np.full(b, t_spec, np.int32),
        "wav": rng.uniform(-0.5, 0.5, (b, t_spec * d.hop_length, 1)
                           ).astype(np.float32),
        "wav_lengths": np.full(b, t_spec * d.hop_length, np.int32),
    }
    if device_spec:
        del batch["spec"]
        t_wav = t_spec * d.hop_length + d.filter_length - d.hop_length
        batch["wav"] = rng.randint(-16384, 16384, (b, t_wav, 1)
                                   ).astype(np.int16)
    return batch


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def step_precision(cfg, device) -> tuple:
    """(name, peak ops/s) of the precision the step computes in."""
    dtype = torch.bfloat16 if cfg.train.fp16_run else torch.float32
    return timing.peak_for(dtype, device.type == "cuda"
                           and timing.tf32_enabled())


# the functions of the eager step each half's CUDA events enclose
HALVES = {"d_step_ms": ("d_backward", "d_update"),
          "g_step_ms": ("g_backward", "g_update")}


@contextlib.contextmanager
def marked_halves():
    """While open, each call of an eager step's function in `HALVES`
    records CUDA events around itself: yields {name: (start, end)}, the
    last call's."""
    from mb_istft_vits_torch.train import step as tstep

    marks = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            marks[name] = (start, end)
            return out
        return run

    with contextlib.ExitStack() as stack:
        for name in sum(HALVES.values(), ()):
            stack.enter_context(mock.patch.object(
                tstep, name, timed(name, getattr(tstep, name))))
        yield marks


def halves_ms(begin, marks) -> dict:
    """One eager step's ms from the event `begin` (recorded before it) to
    D's backward (`forward_ms`: the batch prep and generator forward),
    and of each half (`HALVES`), from its `marked_halves` marks."""
    out = {"forward_ms": begin.elapsed_time(marks["d_backward"][0])}
    for half, fns in HALVES.items():
        out[half] = sum(marks[f][0].elapsed_time(marks[f][1]) for f in fns)
    return out


def split_ms(state, batch, steps: int) -> dict:
    """Median CUDA-event ms of the batch prep and generator forward, the D
    half and the G half (each its backward and its update, `HALVES`) over
    `steps` eager train steps."""
    from mb_istft_vits_torch.train import step as tstep

    rows = []
    with marked_halves() as marks:
        for _ in range(steps):
            marks.clear()
            begin = torch.cuda.Event(enable_timing=True)
            begin.record()
            tstep.train_step_eager(state, batch)
            torch.cuda.synchronize()
            rows.append(halves_ms(begin, marks))
    return {k: statistics.median(r[k] for r in rows) for k in rows[0]}


def timed_steps(state, batches, device) -> tuple:
    """(mean host ms, mean device ms or None on the CPU) a step over
    `batches` (each one step), queued with one device sync at the end;
    CUDA events before the first step and after the last."""
    from mb_istft_vits_torch.train.step import train_step

    on_card = torch.device(device).type == "cuda"
    timing.sync(device)
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    n = 0
    for batch in batches:
        metrics = train_step(state, batch)
        n += 1
    if on_card:
        end.record()
    float(metrics["loss/g/total"])
    host_ms = (time.perf_counter() - t0) / n * 1e3
    return host_ms, start.elapsed_time(end) / n if on_card else None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=CONFIG)
    p.add_argument("--batch", type=int, default=0,
                   help="override batch size (0 = config)")
    p.add_argument("--spec-frames", type=int, default=400)
    p.add_argument("--text-len", type=int, default=192)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--no-donate", action="store_true",
                   help="accepted for the JAX script's callers; unused")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mixed-precision compute (fp16_run)")
    p.add_argument("--feed-host", action="store_true",
                   help="also time steps fed a host batch every step, in "
                        "line and double-buffered (data.device_prefetch)")
    p.add_argument("--device-spec", action="store_true",
                   help="int16 audio only, the spectrogram computed in "
                        "the step (the trainer's default feed)")
    p.add_argument("--widen", type=int, default=1,
                   help="multiply the model's channel widths by N")
    p.add_argument("--flops", action="store_true",
                   help="count one step's FLOPs; report the achieved rate "
                        "and mfu against the peak of the step's precision")
    timing.add_device_argument(p)
    return p


def graph_fields(state) -> dict:
    """The step graphs' counts: signatures stepped at, captures, their
    seconds and the pool's bytes (the last two null off a card)."""
    g = state.graphs
    captured = g is not None and g.captures > 0
    return {"graphs": len(g.keys()) if g is not None else 0,
            "captures": g.captures if g is not None else 0,
            "capture_s": sum(g.capture_seconds.values()) if captured
            else None,
            "pool_bytes": g.pool_bytes() if captured else None}


def _slowest(record: dict) -> dict:
    """Each rank's `record`, gathered once: the largest of each value
    over the ranks (None where a rank has none), and the FLOP and byte
    counts summed."""
    if not dist.is_initialized():
        return record
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, record)
    out = {}
    for k in record:
        vals = [r[k] for r in ranks]
        if any(v is None for v in vals):
            out[k] = None
        else:
            out[k] = sum(vals) if k in ("flops", "bytes") else max(vals)
    return out


def main(argv=None) -> int:
    from mb_istft_vits_torch.parallel import init_distributed

    args = build_parser().parse_args(argv)
    own_group = not dist.is_initialized()
    # torchrun's environment starts a group, each rank on card LOCAL_RANK;
    # else there is none. In a running group the caller chose the card
    device = timing.tool_device(init_distributed(device=args.device).device
                                if own_group else args.device)
    try:
        return run(args, device)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def run(args, device) -> int:
    """The bench of `main` on `device`, in the process group if one is
    running."""
    from mb_istft_vits_torch.data.prefetch import device_prefetch
    from mb_istft_vits_torch.infer.graphs import WARMUP_ITERS
    from mb_istft_vits_torch.parallel import shard_train_state_dp
    from mb_istft_vits_torch.train.step import (create_train_state,
                                                train_step, train_step_eager)

    on_card = device.type == "cuda"
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))
    cfg = load_config(args.config, args.batch, args.bf16, args.widen)
    b, d = cfg.train.batch_size, cfg.data
    if b % world:
        raise ValueError(f"a global batch of {b} does not split over "
                         f"{world} ranks")
    rows = b // world
    host = {k: v[rank * rows:(rank + 1) * rows] for k, v in synthetic_batch(
        cfg, b, args.spec_frames, args.text_len, args.device_spec).items()}
    batch = to_device(host, device)
    state = shard_train_state_dp(create_train_state(cfg, device, seed=0))

    # the warm-up steps and the capture, up to the first replay
    first_steps = 1 + (WARMUP_ITERS if on_card else 0)
    t0 = time.perf_counter()
    for i in range(first_steps):
        metrics = train_step(state, batch)
        if i == 0:
            loss_g = float(metrics["loss/g/total"])
    float(metrics["loss/g/total"])
    out = {"metric": "train_step", "first_step_s": time.perf_counter() - t0,
           "first_steps": first_steps, "first_loss_g": loss_g, "batch": b,
           "spec_frames": args.spec_frames, "text_len": args.text_len,
           "widen": args.widen, "bf16": bool(cfg.train.fp16_run),
           "peak_memory_bytes": None,
           "device_spec": args.device_spec, "devices": world,
           "steps": args.steps}
    out.update(split_ms(state, batch, args.steps) if on_card else
               dict.fromkeys(("forward_ms", *HALVES)))

    # synced every step: adds the host's wait for each step's end
    timing.sync(device)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        metrics = train_step(state, batch)
        float(metrics["loss/g/total"])
    sync_ms = (time.perf_counter() - t0) / args.steps * 1e3
    # queued: one sync at the end, as training runs
    host_ms, dev_ms = timed_steps(state, [batch] * args.steps, device)
    counted = (timing.count(lambda: train_step_eager(state, batch))
               if args.flops else {})
    counted = {k: counted.get(k) for k in ("flops", "bytes")}
    slowest = _slowest({"step_ms": dev_ms, "step_ms_host": host_ms,
                        "step_ms_sync": sync_ms, **counted})
    dev_ms, host_ms = slowest["step_ms"], slowest["step_ms_host"]
    out.update(step_ms_sync=slowest["step_ms_sync"], step_ms=dev_ms,
               step_ms_host=host_ms, steps_per_s=1e3 / host_ms)

    if args.flops:
        precision, peak = step_precision(cfg, device)
        achieved = None if dev_ms is None else slowest["flops"] / (
            dev_ms / 1e3)
        out.update(flops_per_step=slowest["flops"],
                   bytes_per_step=slowest["bytes"], peak=precision,
                   peak_tflops=peak / 1e12,
                   achieved_tflops=None if achieved is None
                   else achieved / 1e12,
                   mfu=None if achieved is None
                   else achieved / (peak * world))
    if args.feed_host:
        nbytes = sum(a.nbytes for a in host.values())
        out["step_ms_host_fed"] = timed_steps(
            state, (to_device(host, device) for _ in range(args.steps)),
            device)[0]
        out["step_ms_double_buffered"] = timed_steps(
            state, device_prefetch((dict(host) for _ in range(args.steps)),
                                   device=device), device)[0]
        out.update(feed_mb_per_step=nbytes / 1e6,
                   feed_gb_per_s=nbytes / out["step_ms_host_fed"] / 1e6)

    metrics = train_step(state, batch)
    out.update(graph_fields(state))
    if on_card:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    out["audio_s_per_s"] = (b * args.spec_frames * d.hop_length
                            / d.sampling_rate / (host_ms / 1e3))
    for k in ("loss/g/total", "loss/d/total", "grad_norm_g"):
        out[k] = float(metrics[k])
    out["all_finite"] = all(np.isfinite(out[k]) for k in
                            ("loss/g/total", "loss/d/total", "grad_norm_g"))
    if rank == 0:
        timing.emit(out, device)
    if not out["all_finite"]:
        raise AssertionError("train step metrics are not finite")
    return 0


if __name__ == "__main__":
    sys.exit(main())
