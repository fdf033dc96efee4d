"""One rank of a data-parallel training run of the PyTorch port, for the
tests and chip_smoke.py. It imports the port only (no JAX); the ranks are
started, set up and checked with `mb_istft_vits_torch.parallel.dryrun`'s
launcher and rank helpers.

    python tests/torch_port_dist_worker.py SPEC RANK

SPEC is a `torch.save`d dict: "address", "world", "device", "backend",
"timeout" (seconds), "cfg" (a `Config`), "seed" (the weights:
`seeded_state`), "batch" (the global batch, CPU tensors), "draws" (its
global `StepDraws`, or None), "n_model" (1: DDP; more: FSDP2 over a
(world / n_model) x n_model mesh), "dp_dropout" (the duration
predictor's dropout), "compare" (a list of cuDNN settings, {"enabled",
"deterministic"}, one compared step each; default one step as it is),
"restart" (a `Config`: the timed steps' optimizers), "steps" (timed
steps), "out" (a directory).

The rank builds the weights itself, runs one compared step for each
setting, each from those weights with fresh optimizers of "cfg" and on
"draws", then `steps` timed steps from the same weights with fresh
optimizers of "restart", on its rows of the batch, and writes RANK.pt to
"out": per step ("compared", "steps") its metrics, a digest of every
weight, its MAS launches and its synced host ms; rank 0 also the nets'
state dicts after each compared step ("g", "d"; under FSDP2 the first is
written through `checkpoint.save`, as G_1.pth / D_1.pth); under FSDP2
the names of the sharded weights and of the moments that carry their
weight's placement (`placements`); on a card, the milliseconds of an
all-reduce of every weight's bytes (a buffer of that size on its own,
outside the steps).
"""

from __future__ import annotations

import faulthandler
import os
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mb_istft_vits_torch.ops import mas  # noqa: E402
from mb_istft_vits_torch.parallel import dryrun  # noqa: E402
from mb_istft_vits_torch.train import checkpoint  # noqa: E402
from mb_istft_vits_torch.train import step as tstep  # noqa: E402


def seeded_state(cfg, device, seed: int, dp_dropout=None):
    """`create_train_state(cfg, device, seed)` with every all-zero floating
    tensor (the flow couplings' output convs) filled with seeded noise, so
    no layer behind them is without a gradient; the duration predictor's
    dropout set to `dp_dropout` when given. Every rank and the
    single-process reference build the same weights so."""
    state = tstep.create_train_state(cfg, torch.device(device), seed=seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for net in (state.net_g, state.net_d):
            for v in net.state_dict().values():
                if v.is_floating_point() and not v.any():
                    v.copy_(0.1 * torch.randn(v.shape, generator=gen))
    if dp_dropout is not None:
        state.net_g.dp.drop.p = dp_dropout
    return state


def placements(p) -> list:
    """A DTensor's placements as ["R"] / ["S", dim] lists."""
    return [["S", pl.dim] if pl.is_shard() else ["R"]
            for pl in p.placements]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def allreduce_ms(nbytes: int, device, reps: int = 5) -> float:
    """Median ms of an all-reduce of one `nbytes` buffer of float32 on
    `device`."""
    buf = torch.ones(nbytes // 4, device=device)
    dist.all_reduce(buf)
    times = []
    for _ in range(reps):
        _sync(device)
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def reset(state, init, cfg) -> None:
    """Back to the weights `init` ((G, D) state dicts), with fresh
    optimizers of `cfg`, at step 0 (DDP's wrappers hold the same
    parameters)."""
    with torch.no_grad():
        state.net_g.load_state_dict(init[0])
        state.net_d.load_state_dict(init[1])
    state.cfg, state.step = cfg, 0
    state.optim_g = tstep.make_optimizer(state.net_g.parameters(), cfg.train)
    state.optim_d = tstep.make_optimizer(state.net_d.parameters(), cfg.train)


def launch(spec: dict, out_dir: str, timeout: float = 300.0) -> list:
    """Run `spec["world"]` ranks of this script on a free port and return
    their RANK.pt dicts, in rank order; raises with a rank's stderr when
    one fails. No rank outlives the call."""
    spec = dict(spec, out=out_dir,
                address=f"tcp://localhost:{dryrun.free_port()}")
    spec.setdefault("timeout", timeout)
    path = os.path.join(out_dir, "spec.pt")
    torch.save(spec, path)
    dryrun.run_ranks(lambda r: [sys.executable, os.path.abspath(__file__),
                                path, str(r)], spec["world"],
                     timeout=timeout)
    return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
            for r in range(spec["world"])]


def main(spec_path: str, rank: int) -> int:
    faulthandler.enable()  # a crash in a collective prints its stack
    spec = torch.load(spec_path, weights_only=False)
    with dryrun.rank_group(spec["address"], spec["world"], rank,
                           spec["device"], spec["backend"],
                           spec["timeout"]) as info:
        if info.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        torch.manual_seed(0)  # dropout, the same on every rank (the CLI's)
        state = seeded_state(spec["cfg"], info.device, spec["seed"],
                             spec.get("dp_dropout"))
        n_model = spec.get("n_model", 1)
        timed = spec.get("steps", 0)
        init = None
        if timed or len(spec.get("compare", [{}])) > 1:
            init = tuple({k: v.detach().clone() for k, v in
                          net.state_dict().items()}
                         for net in (state.net_g, state.net_d))
        dryrun.shard_state(state, n_model)
        batch = dryrun.rank_rows(spec["batch"], state)
        draws = spec.get("draws")
        if draws is not None:
            draws = tstep.StepDraws(*(None if v is None else v.to(info.device)
                                      for v in draws))
        out = {"rank": rank, "steps": []}

        def step(draws):
            launches = mas.launch_counts["mas_fused"] \
                + mas.launch_counts["mas_fwd"]
            _sync(info.device)
            t0 = time.perf_counter()
            metrics = tstep.train_step(state, batch, draws)
            metrics = {k: float(v) for k, v in metrics.items()}
            _sync(info.device)
            return {"host_ms": (time.perf_counter() - t0) * 1e3,
                    "metrics": metrics,
                    "mas_launches": mas.launch_counts["mas_fused"]
                    + mas.launch_counts["mas_fwd"] - launches,
                    "digest": dryrun.digest((state.net_g, state.net_d))}

        out["compared"], out["g"], out["d"] = [], [], []
        for i, setting in enumerate(spec.get("compare", [{}])):
            if i:
                reset(state, init, spec["cfg"])
            # flags() would turn cuDNN's TF32 on unless told not to
            with torch.backends.cudnn.flags(
                    enabled=setting.get("enabled", True),
                    deterministic=setting.get("deterministic", False),
                    benchmark=False, allow_tf32=False):
                out["compared"].append(step(draws))
            if i == 0 and n_model > 1:
                checkpoint.save(spec["out"], state)
            elif rank == 0:
                out["g"].append({k: v.detach().cpu().clone() for k, v in
                                 state.net_g.state_dict().items()})
                out["d"].append({k: v.detach().cpu().clone() for k, v in
                                 state.net_d.state_dict().items()})
        if timed:
            reset(state, init, spec["restart"])
            out["steps"] = [step(None) for _ in range(timed)]
        if n_model > 1:
            out["sharded"], out["moments"] = {}, {}
            for prefix, net, optim in (("g", state.net_g, state.optim_g),
                                       ("d", state.net_d, state.optim_d)):
                for name, p in net.named_parameters():
                    if not hasattr(p, "placements"):
                        continue
                    out["sharded"][f"{prefix}.{name}"] = placements(p)
                    moments = optim.state.get(p, {})
                    if all(getattr(moments.get(k), "placements", None)
                           == p.placements for k in ("exp_avg",
                                                     "exp_avg_sq")):
                        out["moments"][f"{prefix}.{name}"] = placements(p)
        out["launch_counts"] = dict(mas.launch_counts)
        if info.device.type == "cuda":
            nbytes = 4 * sum(p.numel() for net in (state.net_g, state.net_d)
                             for p in net.parameters())
            out["allreduce_bytes"] = nbytes
            out["allreduce_ms"] = allreduce_ms(nbytes, info.device)
        torch.save(out, os.path.join(spec["out"], f"{rank}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
