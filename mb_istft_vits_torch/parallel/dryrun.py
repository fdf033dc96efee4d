"""One whole training step over n ranks on tiny shapes, then the
flagship's step graphs captured on each production layout (the analog of
the JAX package's `__graft_entry__.dryrun_multichip`).

    python -m mb_istft_vits_torch.parallel.dryrun N [--device cuda|cpu]

`dryrun_multichip(n)` starts n processes, one rank each, and runs one D +
G step of a tiny multi-band model on a global batch of n rows: for n >= 4
(even) over the 2-D (data x model) mesh of `parallel.tp`, n/2 x 2, each
data replica taking two rows; for smaller n data-parallel, one row
a rank. Ranks use NCCL on distinct cards, and gloo when they share one
card or run on the CPU. It checks that every rank ends with the same
finite losses and the same weights, and prints one line.

Then, unless MBIV_DRYRUN_FLAGSHIP=0, the same ranks build the flagship
`ljs_mb_istft_vits` at its batch (64, global) in bf16 (`fp16_run`) on
JAX's synthetic batch (t_spec 400, t_x 192) and take, on each layout
JAX's code builds for n (the tiny step's, and for a 2-D one also the 1-D
data=n layout), the step graphs' warm-up steps and capture, with no
timed replay: a capture is what a CUDA graph has in place of JAX's
compile. Each layout prints JAX's line, "captured" for "compiled". On
the CPU each layout runs the step body once and captures nothing.

The launcher (`start_ranks`, `finish_ranks`, `run_ranks`) and a rank's
set-up (`rank_group`, `shard_state`, `rank_rows`, `digest`) are the ones
the port's multi-rank tests and chip_smoke.py drive their ranks with.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import gc
import hashlib
import json
import math
import os
import socket
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mb_istft_vits_torch.config import Config, DataConfig, ModelConfig, \
    TrainConfig

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FLAGSHIP_CONFIG = os.path.join(_REPO, "configs", "ljs_mb_istft_vits.json")
# JAX's flagship half: the config's batch, these frames and tokens
FLAGSHIP_SHAPE = {"batch": None, "t_spec": 400, "t_x": 192}


def tiny_config() -> Config:
    """The JAX dryrun's tiny multi-band model (8 kHz, hop 64)."""
    model = ModelConfig(
        n_vocab=178, spec_channels=129, segment_size=8,
        inter_channels=32, hidden_channels=32, filter_channels=64,
        n_heads=2, n_layers=2, kernel_size=3, p_dropout=0.1,
        resblock="1", resblock_kernel_sizes=(3, 7),
        resblock_dilation_sizes=((1, 3), (1, 3)),
        upsample_rates=(2, 2), upsample_initial_channel=64,
        upsample_kernel_sizes=(4, 4), gen_istft_n_fft=16,
        gen_istft_hop_size=4, subbands=4, mb_istft_vits=True,
    )
    data = DataConfig(filter_length=256, hop_length=64, win_length=256,
                      n_mel_channels=20, sampling_rate=8000)
    train = TrainConfig(batch_size=8, segment_size=512,
                        fft_sizes=(32, 64), hop_sizes=(8, 16),
                        win_lengths=(32, 64), steps_per_epoch=10)
    return Config(model=model, data=data, train=train)


def tiny_batch(b: int, t_x: int = 12, t_spec: int = 32, hop: int = 64,
               n_fft: int = 256) -> Dict[str, torch.Tensor]:
    """The JAX dryrun's device-spec batch of b rows, on the CPU: int16 PCM
    in a buffer of t_spec * hop + (n_fft - hop) samples."""
    g = torch.Generator().manual_seed(0)
    t_wav = t_spec * hop + (n_fft - hop)
    return {
        "x": torch.randint(1, 170, (b, t_x), generator=g, dtype=torch.int32),
        "x_lengths": torch.full((b,), t_x, dtype=torch.int32),
        "spec_lengths": torch.full((b,), t_spec, dtype=torch.int32),
        "wav": torch.randint(-16000, 16000, (b, t_wav, 1), generator=g,
                             dtype=torch.int16),
        "wav_lengths": torch.full((b,), t_spec * hop, dtype=torch.int32),
    }


def flagship_batch(cfg: Config, b: int, t_spec: int, t_x: int
                   ) -> Dict[str, torch.Tensor]:
    """JAX's synthetic flagship batch of b rows (numpy seed 0: the ids,
    then the int16 PCM), on the CPU."""
    d = cfg.data
    rng = np.random.RandomState(0)
    t_wav = t_spec * d.hop_length + (d.filter_length - d.hop_length)
    x = rng.randint(1, cfg.model.n_vocab, size=(b, t_x)).astype(np.int32)
    wav = rng.randint(-16000, 16000, (b, t_wav, 1)).astype(np.int16)
    return {"x": torch.from_numpy(x),
            "x_lengths": torch.full((b,), t_x, dtype=torch.int32),
            "spec_lengths": torch.full((b,), t_spec, dtype=torch.int32),
            "wav": torch.from_numpy(wav),
            "wav_lengths": torch.full((b,), t_spec * d.hop_length,
                                      dtype=torch.int32)}


def layout(n_devices: int):
    """(n_data, n_model) of the dryrun's mesh for n ranks."""
    if n_devices >= 4 and n_devices % 2 == 0:
        return n_devices // 2, 2
    return n_devices, 1


def layouts(n_devices: int) -> List[Tuple[int, int]]:
    """The flagship half's layouts, as JAX's builds them: the tiny step's
    mesh, and after a 2-D one the 1-D data=n mesh."""
    first = layout(n_devices)
    return [first] + ([(n_devices, 1)] if first[1] > 1 else [])


def kind(n_data: int, n_model: int) -> str:
    return (f"data={n_data} x model={n_model}" if n_model > 1
            else f"data={n_data}")


def free_port() -> int:
    """A TCP port on localhost that no one listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(argv: Callable[[int], List[str]], world: int, *,
                env: Optional[Callable[[int], Dict[str, str]]] = None,
                cwd: Optional[str] = None, merge_stderr: bool = False
                ) -> List[subprocess.Popen]:
    """Start `world` processes, one a rank: `argv(r)` is rank r's command
    and `env(r)` what it adds to this process's environment, beside two
    torch threads and the repo on PYTHONPATH. stdout and stderr are pipes
    (stderr into stdout with `merge_stderr`)."""
    base = dict(os.environ, OMP_NUM_THREADS="2")
    base["PYTHONPATH"] = _REPO + os.pathsep + base.get("PYTHONPATH", "")
    return [subprocess.Popen(
        argv(r), env=dict(base, **(env(r) if env else {})), cwd=cwd,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT if merge_stderr else subprocess.PIPE,
        text=True) for r in range(world)]


def kill_ranks(procs: List[subprocess.Popen]) -> None:
    """Kill every rank still running and reap it."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_ranks(procs: List[subprocess.Popen], timeout: float
                 ) -> List[Tuple[int, str, str]]:
    """Wait for each rank (`timeout` seconds at most, each); returns
    (exit code, stdout, stderr) in rank order. No rank outlives the call."""
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            results.append((p.returncode, out, err or ""))
    finally:
        kill_ranks(procs)
    return results


def run_ranks(argv: Callable[[int], List[str]], world: int, *,
              timeout: float) -> List[str]:
    """`start_ranks` and `finish_ranks`; raises with the stderr of each
    rank that failed, else returns the ranks' stdouts."""
    results = finish_ranks(start_ranks(argv, world), timeout)
    errors = [f"rank {r} exited {rc}:\n{err[-3000:]}"
              for r, (rc, _, err) in enumerate(results) if rc]
    if errors:
        raise RuntimeError("\n".join(errors))
    return [out for _, out, _ in results]


@contextlib.contextmanager
def rank_group(address: str, world: int, rank: int, device: str,
               backend: Optional[str], timeout: float):
    """This process as rank `rank` of `world` (`init_distributed`, every
    collective bounded by `timeout` seconds); yields its `DistInfo` and
    ends the group on the way out."""
    from mb_istft_vits_torch.parallel import init_distributed

    info = init_distributed(address, world, rank, device=device,
                            backend=backend,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        yield info
    finally:
        dist.destroy_process_group()


def shard_state(state, n_model: int):
    """`state` data-parallel when `n_model` is 1, else sharded over the
    (world / n_model) x n_model mesh. Returns `state`."""
    from mb_istft_vits_torch.parallel import (
        create_2d_mesh,
        shard_train_state_dp,
        shard_train_state_tp,
    )

    if n_model > 1:
        return shard_train_state_tp(state, create_2d_mesh(
            n_model, device_type=state.device.type))
    return shard_train_state_dp(state)


def rank_rows(batch: Dict[str, torch.Tensor], state
              ) -> Dict[str, torch.Tensor]:
    """The state's data rank's rows of the global `batch`, on its device
    (every model rank of a data replica takes the same rows)."""
    rows = batch["x"].shape[0] // state.data_world
    lo = state.data_rank * rows
    return {k: v[lo:lo + rows].to(state.device) for k, v in batch.items()}


def digest(nets) -> str:
    """A hash of every weight's bits; equal weights, equal digests."""
    h = hashlib.sha1()
    for net in nets:
        for k, v in sorted(net.state_dict().items()):
            h.update(k.encode())
            h.update(v.detach().cpu().reshape(-1).view(torch.uint8)
                     .numpy().data)
    return h.hexdigest()


def run_flagship(world: int, device: torch.device, shape: dict
                 ) -> List[dict]:
    """This rank's part of the flagship half: for each of `layouts(world)`
    a fresh flagship state (seed 0, bf16) sharded so, stepped on its rows
    of JAX's batch at `shape` ({"batch" (None: the config's), "t_spec",
    "t_x"}) through `train_step`: on a card its warm-up steps and its
    capture, on the CPU one step. Returns per layout the shapes, G's
    parameter count, the last step's metrics, a digest of the weights,
    and the graphs' stages, capture seconds, pool bytes and the card's
    peak reserved bytes (None on the CPU)."""
    from mb_istft_vits_torch.infer.graphs import WARMUP_ITERS
    from mb_istft_vits_torch.train.step import create_train_state, train_step

    cfg = Config.from_json(FLAGSHIP_CONFIG)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, fp16_run=True))
    b = shape.get("batch") or cfg.train.batch_size
    batch = flagship_batch(cfg, b, shape["t_spec"], shape["t_x"])
    out = []
    on_card = device.type == "cuda"
    for n_data, n_model in layouts(world):
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        state = shard_state(create_train_state(cfg, device, seed=0), n_model)
        rows = rank_rows(batch, state)
        steps = WARMUP_ITERS + 1 if on_card else 1
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = train_step(state, rows)
        metrics = {k: float(v) for k, v in metrics.items()}
        g = state.graphs
        captured = g is not None and g.captures > 0
        out.append({
            "kind": kind(n_data, n_model), "batch": b,
            "rows_per_rank": rows["x"].shape[0],
            "t_spec": shape["t_spec"], "t_x": shape["t_x"],
            "g_params": sum(p.numel() for p in state.net_g.parameters()),
            "steps": steps, "seconds": time.perf_counter() - t0,
            "metrics": metrics, "digest": digest((state.net_g, state.net_d)),
            "captured": captured,
            "graphs_a_step": list(g.graphs_a_step.values())[-1]
            if captured else None,
            "capture_seconds": list(g.capture_seconds.values())[-1]
            if captured else None,
            "pool_bytes": g.pool_bytes() if captured else None,
            "peak_bytes": torch.cuda.max_memory_reserved(device)
            if on_card else None})
        del state, rows, g
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return out


def run_rank(rank: int, world: int, address: str, device: str,
             backend: str, flagship: Optional[dict] = None) -> dict:
    """One rank's tiny step, then the flagship half at the shape
    `flagship` (None: skipped); returns its losses, a digest of its
    weights after the step, the flagship half's layouts and its MAS
    launch counts."""
    from mb_istft_vits_torch.ops import mas
    from mb_istft_vits_torch.train.step import create_train_state, train_step

    with rank_group(address, world, rank, device, backend, 300) as info:
        torch.manual_seed(0)  # dropout, the same on every rank (the CLI's)
        state = shard_state(create_train_state(tiny_config(), info.device,
                                               seed=0), layout(world)[1])
        metrics = train_step(state, rank_rows(tiny_batch(world), state))
        out = {"rank": rank, "data_rank": state.data_rank,
               "route": "graphs" if state.graphs is not None else "eager",
               "metrics": {k: float(v) for k, v in metrics.items()},
               "digest": digest((state.net_g, state.net_d))}
        del state
        out["flagship"] = (None if flagship is None
                           else run_flagship(world, info.device, flagship))
        out["launch_counts"] = dict(mas.launch_counts)
        return out


def _agree(results: List[dict]) -> bool:
    """Every rank's metrics and digest equal, the metrics finite."""
    same = {json.dumps([r["metrics"], r["digest"]], sort_keys=True)
            for r in results}
    return len(same) == 1 and all(
        math.isfinite(v) for v in results[0]["metrics"].values())


def dryrun_multichip(n_devices: int, *, device: str = "cuda",
                     timeout: float = 600.0,
                     flagship_shape: Optional[dict] = None) -> dict:
    """Run the step over `n_devices` ranks, then the flagship half
    (module docstring) at `flagship_shape` (keys of FLAGSHIP_SHAPE; None:
    JAX's) unless MBIV_DRYRUN_FLAGSHIP=0; raises unless every rank exits
    0 with the same finite losses and the same weights, in the tiny step
    and on each flagship layout. Returns {"kind", "backend", "route" (the
    step's: "graphs"), "loss_g", "ranks", "flagship" (per layout: its
    kind, shapes, G's parameters, whether it captured, and each rank's
    stages, capture seconds and pool bytes; [] when skipped), "lines"}."""
    n_data, n_model = layout(n_devices)
    shape = None
    if os.environ.get("MBIV_DRYRUN_FLAGSHIP", "1") != "0":
        shape = dict(FLAGSHIP_SHAPE, **(flagship_shape or {}))
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        distinct = n_devices <= torch.cuda.device_count()
    backend = "nccl" if device == "cuda" and distinct else "gloo"
    address = f"tcp://localhost:{free_port()}"
    outs = run_ranks(lambda r: [
        sys.executable, "-m", "mb_istft_vits_torch.parallel.dryrun",
        str(n_devices), "--rank", str(r), "--address", address,
        "--device", device if device == "cpu" else
        f"cuda:{r if distinct else 0}", "--backend", backend,
        "--flagship", json.dumps(shape)],
        n_devices, timeout=timeout)
    results = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    loss_g = results[0]["metrics"]["loss/g/total"]
    if not _agree(results):
        raise AssertionError(f"ranks disagree or are not finite: {results}")
    route = results[0]["route"]
    lines = [f"dryrun_multichip({n_devices}): ok ({kind(n_data, n_model)}, "
             f"{backend}, step route {route}), loss_g={loss_g:.4f}"]
    flagship = []
    for i in range(len(layouts(n_devices)) if shape else 0):
        per_rank = [r["flagship"][i] for r in results]
        if not _agree(per_rank):
            raise AssertionError(f"flagship {per_rank[0]['kind']}: ranks "
                                 f"disagree or are not finite: {per_rank}")
        f = per_rank[0]
        done = ("captured" if all(r["captured"] for r in per_rank)
                else "ran")
        how = (f"{f['steps'] - 1} warm-up steps and the capture of "
               f"{f['graphs_a_step']} stage graph(s)" if done == "captured"
               else "the step body once, nothing captured")
        lines.append(
            f"dryrun_multichip({n_devices}): flagship ljs_mb_istft_vits "
            f"b{f['batch']} bf16 t_spec={f['t_spec']} {done} on "
            f"{f['kind']} ({f['g_params'] / 1e6:.1f}M G params; {how})")
        flagship.append(dict(
            {k: f[k] for k in ("kind", "batch", "rows_per_rank", "t_spec",
                               "t_x", "g_params", "captured",
                               "graphs_a_step")},
            **{k: [r[k] for r in per_rank] for k in (
                "capture_seconds", "pool_bytes", "peak_bytes",
                "seconds")}))
    for line in lines:
        print(line, flush=True)
    return {"kind": kind(n_data, n_model), "backend": backend,
            "route": route, "loss_g": loss_g, "ranks": results,
            "flagship": flagship, "lines": lines}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)  # a rank of the dryrun
    ap.add_argument("--address", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--backend", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--flagship", default="null", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is None:
        dryrun_multichip(args.n_devices, device=args.device)
    else:
        print(json.dumps(run_rank(args.rank, args.n_devices, args.address,
                                  args.device, args.backend,
                                  json.loads(args.flagship))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
