"""Data-parallel training traffic: the port's training step over `world`
cards (the cell's chips), one process a card over NCCL, each rank on its
own `batch` rows of every global batch, the step's stage graphs with
their two all-reduces a step (`train.step.drive`), as the published
`train_ms.py` trains on a multi-GPU node.

Rank 0 runs in the harness's process and spawns ranks 1 to world - 1
beside it. Every rank makes the run of `drivers.train` at the global
batch (`batch` x world rows, the same rows, draws and weights on every
rank, all from the seed) and steps on its own chunk of each batch, rows
[rank * batch, (rank + 1) * batch), with its state made data-parallel
(`parallel.mesh.shard_train_state_dp`). A checked step's dropout is
seeded with that step's seed plus the rank; each other signature's first
replay with one seed on every rank. Set-up ends with one timed cycle, from
which rank 0 fixes the window's steps, at least `seconds` of them, and
tells every rank: a collective cannot stop on one rank's clock. The
window's audio is every rank's real audio; its operations and alignment
shapes, read by the per-layer metrics, are rank 0's.

After the window rank 0 frees its state and holds the first steps, and
each other signature's first replay, to the plain reference
(`perfbench.reference.train_dp`): every rank's chunk, forwarded under that
rank's dropout seed, the gradient summed over the ranks. A rank that
fails ends the run: rank 0 ends every rank and exits at once, so no rank
waits on a collective that will not come."""

from __future__ import annotations

import datetime
import os
import socket
import threading
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from perfbench.drivers import train as single
from perfbench.reference import train_dp as reference
from perfbench.reference.precision import float32
from perfbench.yardstick import compare, corpus, flops

TIMEOUT = datetime.timedelta(minutes=10)  # of every collective


def rank_seed(seed: int, rank: int) -> int:
    """The dropout seed of `rank` in a step seeded `seed`."""
    return (seed + rank) % (1 << 62)


def _slice(step, lo: int, hi: int):
    batch, draws, lengths = step
    return ({k: v[lo:hi].contiguous() for k, v in batch.items()},
            type(draws)(*(None if v is None else v[lo:hi].contiguous()
                          for v in draws)), lengths[lo:hi])


class RankRun(single.TrainRun):
    """One rank's run: `drivers.train`'s at the global batch, stepped on
    this rank's chunk of each batch."""

    def __init__(self, ctx, rank: int, world: int):
        from mb_istft_vits_torch.parallel.mesh import shard_train_state_dp

        wl = ctx.workload
        self.rank, self.world, self.per = rank, world, wl["batch"]
        ctx.workload = dict(wl, batch=wl["batch"] * world)
        try:
            super().__init__(ctx)
        finally:
            ctx.workload = wl
        lo, hi = rank * self.per, (rank + 1) * self.per
        self.full_lengths = [lengths for _, _, lengths in self.steps]
        self.full_checked = self.checked if rank == 0 else None
        self.full_steps = self.steps if rank == 0 else None
        self.checked = [_slice(s, lo, hi) for s in self.checked]
        self.steps = [_slice(s, lo, hi) for s in self.steps]
        self.base_seeds = self.dropout_seeds
        self.dropout_seeds = [rank_seed(s, rank) for s in self.base_seeds]
        shard_train_state_dp(self.state)

    def warm(self) -> List[Dict[str, float]]:
        """`drivers.train`'s, then one timed cycle; rank 0 keeps every
        rank's chunk of each replayed step for the reference."""
        losses = super().warm()
        seen, firsts = {self.order[0]}, []
        for i, b in enumerate(self.order):
            if b not in seen:
                seen.add(b)
                firsts.append(i)
        if self.rank == 0:
            for held, i in zip(self.replays, firsts):
                held["chunks"] = self._chunks(self.full_steps[i])
            self.full_steps = None
        self.ctx.sync()
        t0 = time.perf_counter()
        for batch, draws, _ in self.steps:
            self.train_step(self.state, batch, draws)
        self.ctx.sync()
        cycle_s = time.perf_counter() - t0
        n = torch.tensor([int(np.ceil(self.ctx.seconds / cycle_s
                                      * len(self.steps)))],
                         device=self.ctx.device)
        dist.broadcast(n, 0)
        self.window_steps = max(1, int(n))
        self.ctx.log(f"cycle {cycle_s:.3f} s: {self.window_steps} steps "
                     "in the window")
        return losses

    def _chunks(self, step) -> List[tuple]:
        """Every rank's (batch, draws) of a global step, in the
        reference's layout."""
        batch, draws, _ = step
        out = []
        for r in range(self.world):
            lo, hi = r * self.per, (r + 1) * self.per
            out.append(({k: v[lo:hi] for k, v in batch.items()},
                        {"posterior_eps":
                         draws.posterior_eps.transpose(1, 2)[lo:hi],
                         "ids_slice": draws.ids_slice[lo:hi]}))
        return out

    def window(self) -> Dict:
        """The window's fixed steps, at most two in flight, then two
        trailing steps (traced on a traced rank)."""
        ctx, steps, state = self.ctx, self.steps, self.state
        sr = ctx.config["data"]["sampling_rate"]
        audio = [sum(s for _, _, s in lengths) / sr
                 for lengths in self.full_lengths]
        step_flops = [flops.step_flops(ctx.config, [(tx, ty) for tx, ty, _
                                                    in lengths])
                      for _, _, lengths in steps]
        mas = [(corpus.BOUNDARIES[b + 1], self.cap,
                [(ty, tx) for tx, ty, _ in steps[i][2]])
               for i, b in enumerate(self.order)]
        flight: List = []
        with ctx.tracer:
            with ctx.tracer.window():
                t0 = time.perf_counter()
                for done in range(self.window_steps):
                    batch, draws, _ = steps[done % len(steps)]
                    with ctx.tracer.range("perfbench.step"):
                        self.train_step(state, batch, draws)
                    flight.append(ctx.event())
                    if len(flight) > 2:
                        flight.pop(0).synchronize()
                ctx.sync()
                window_s = time.perf_counter() - t0
            # on every rank, traced or not: each step holds collectives
            with ctx.tracer.trailing():
                for i in range(single.TRAILING_STEPS):
                    self.train_step(state, *steps[
                        (self.window_steps + i) % len(steps)][:2])
                ctx.sync()
        done = self.window_steps
        ctx.log(f"window: {done} steps in {window_s:.3f} s")
        window = [i % len(steps) for i in range(done)]
        return {"steps": done, "window_s": window_s,
                "audio_s": sum(audio[i] for i in window),
                "flops": sum(step_flops[i] for i in window),
                "precision": ctx.precision(),
                "mas_shapes": [mas[i] for i in window]}

    def reference(self, rows=None) -> Dict:
        """The reference's readings of the checked steps over every
        rank's chunk, and of each other signature's first replay."""
        steps = [self._chunks(s) for s in self.full_checked]
        seeds = [[rank_seed(s, r) for r in range(self.world)]
                 for s in self.base_seeds]
        g_w = {k[2:]: v for k, v in self.start.items() if k.startswith("g.")}
        d_w = {k[2:]: v for k, v in self.start.items() if k.startswith("d.")}
        out = reference.run(self.ctx.config, g_w, d_w, steps, self.lrs,
                            seeds)
        dev = self.ctx.device
        out["replays"] = []
        for h in self.replays:
            w = {k: v.to(dev) for k, v in h["weights"].items()}
            moments = {k: (m.to(dev), v.to(dev))
                       for k, (m, v) in h["d_moments"].items()}
            out["replays"].append(reference.replay(
                self.ctx.config,
                {k[2:]: v for k, v in w.items() if k.startswith("g.")},
                {k[2:]: v for k, v in w.items() if k.startswith("d.")},
                moments, h.get("d_step", 0), h["chunks"], h["lr"],
                [h["seed"]] * self.world))
        self.ctx.log("reference done")
        return out


def _start(ctx, rank: int, world: int, port: int) -> RankRun:
    from mb_istft_vits_torch.parallel.mesh import init_distributed

    init_distributed(f"tcp://localhost:{port}", world, rank,
                     device=ctx.device, timeout=TIMEOUT)
    return RankRun(ctx, rank, world)


def _rank(args) -> None:
    """Ranks 1 and above, in processes of their own."""
    from perfbench import run as harness

    (cell, seed, seconds, bench, config_path, workload, device_type, rank,
     world, port) = args
    parent = os.getppid()

    def orphaned():  # rank 0 gone: no collective will come
        while True:
            time.sleep(1.0)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=orphaned, daemon=True).start()
    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device("cpu"))
    ctx = harness.context(cell, seed, seconds, False, device, bench,
                          config_path, workload)
    tr = _start(ctx, rank, world, port)
    tr.first_steps()
    tr.warm()
    tr.window()
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _watch(procs) -> None:
    """Ends the run when a rank fails: every rank, then this process."""
    while True:
        time.sleep(1.0)
        if any(p.exitcode not in (None, 0) for p in procs):
            for p in procs:
                if p.exitcode is None:
                    p.kill()
            print("perfbench: a rank failed", flush=True)
            os._exit(1)
        if all(p.exitcode == 0 for p in procs):
            return


def run(ctx) -> Dict:
    import torch.multiprocessing as mp

    # the cell's chips; a rehearsal's workload may name fewer ranks
    world = ctx.workload.get("world", ctx.cell["chips"])
    port = _free_port()
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=_rank, args=((
        ctx.cell["name"], ctx.seed, ctx.seconds, ctx.bench, ctx.config_path,
        ctx.workload, ctx.device.type, r, world, port),), daemon=True)
        for r in range(1, world)]
    for p in procs:
        p.start()
    threading.Thread(target=_watch, args=(procs,), daemon=True).start()
    tr = _start(ctx, 0, world, port)
    prog = tr.first_steps()
    prog["replays"] = tr.warm()
    ctx.sync()
    setup_s = time.time() - ctx.t_start
    counters = tr.window()
    memory_peak = ctx.memory_peak()
    ctx.check_modules()
    dist.barrier()
    dist.destroy_process_group()
    for p in procs:
        p.join()
    tr.free()
    with float32():
        ref = tr.reference()
    return {
        "attempted": counters["steps"], "failed": 0,
        "numbers": compare.train_numbers(prog, ref),
        "memory_peak": memory_peak,
        "end_to_end": {"setup_s": setup_s,
                       "train_audio_s_per_s": counters["audio_s"]
                       / counters["window_s"]},
        "counters": counters,
    }
