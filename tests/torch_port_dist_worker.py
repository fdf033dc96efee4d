"""One rank of a data-parallel training run of the PyTorch port, for the
tests and chip_smoke.py. It imports the port only (no JAX); the ranks are
started, set up and checked with `mb_istft_vits_torch.parallel.dryrun`'s
launcher and rank helpers.

    python tests/torch_port_dist_worker.py SPEC RANK

SPEC is a `torch.save`d dict: "address", "world", "device", "backend",
"timeout" (seconds), "cfg" (a `Config`), "seed" (the weights:
`seeded_state`), "batch" (the global batch, CPU tensors), "draws" (its
global `StepDraws`, or None), "n_model" (1: data-parallel; more: sharded
over a (world / n_model) x n_model mesh), "dp_dropout" (the duration
predictor's dropout), "compare" (a list of cuDNN settings, {"enabled",
"deterministic"}, one compared step each; default one step as it is),
"restart" (a `Config`: the timed steps' optimizers), "steps" (timed
steps), "out" (a directory); on a card also "routes" (queued steps
timed in each of the graphs and eager, `timed_routes`) and
"graph_compare" (cuDNN settings, `replay_vs_eager` each: under cuDNN's
default algorithms on the graphs the timed steps captured, under others
on a capture of its own); "checks" (the
data-parallel route's checks, `route_checks`, with "bench":
`bench_train`'s argv or None; for a sharded state `tp_checks`).

The rank builds the weights itself, runs one compared step for each
setting, each from those weights with fresh optimizers of "cfg" and on
"draws", then `steps` timed steps from the same weights with fresh
optimizers of "restart", on its rows of the batch, and writes RANK.pt to
"out": per step ("compared", "steps") its metrics, a digest of every
weight, its MAS launches, its route (eager, capture or replay) and its
synced host ms; rank 0 also the nets' state dicts after each compared
step ("g", "d"; for a sharded state the first is written through
`checkpoint.save`, as G_1.pth / D_1.pth); for a sharded state the
sharded weights with the shapes of their shards and moments
(`shard_report`); on a card, the milliseconds of an all-reduce of every
weight's bytes (a buffer of that size on its own, outside the steps);
and what "routes", "graph_compare" and "checks" found.
"""

from __future__ import annotations

import collections
import contextlib
import faulthandler
import io
import math
import os
import re
import shutil
import statistics
import sys
import time
from unittest import mock

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mb_istft_vits_torch.infer.graphs import WARMUP_ITERS  # noqa: E402
from mb_istft_vits_torch.ops import mas  # noqa: E402
from mb_istft_vits_torch.parallel import dryrun  # noqa: E402
from mb_istft_vits_torch.train import checkpoint  # noqa: E402
from mb_istft_vits_torch.train import graphs as tgraphs  # noqa: E402
from mb_istft_vits_torch.train import step as tstep  # noqa: E402
from mb_istft_vits_torch.utils import timing  # noqa: E402


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


def shard_report(state) -> dict:
    """Each sharded weight ("g.<name>", "d.<name>"): its sharded
    dimension, its whole shape, its shard's and its AdamW moments'."""
    out = {}
    for prefix, net, optim in (("g", state.net_g, state.optim_g),
                               ("d", state.net_d, state.optim_d)):
        shards = state.shards[prefix]
        names = [name for name, _ in net.named_parameters()]
        for (i, p, d), shard in zip(shards.leaves, shards.shards):
            st = optim.state.get(shard, {})
            out[f"{prefix}.{names[i]}"] = {
                "dim": d, "whole": list(p.shape), "shard": list(shard.shape),
                "moments": [list(st[k].shape) for k in ("exp_avg",
                                                        "exp_avg_sq")
                            if k in st]}
    return out


COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor")


@contextlib.contextmanager
def counting_collectives():
    """Counts the calls of each of COLLECTIVES ({name: calls}) while it is
    open."""
    calls = collections.Counter()
    with contextlib.ExitStack() as stack:
        for name in COLLECTIVES:
            def counting(*args, _real=getattr(dist, name), _name=name,
                         **kwargs):
                calls[_name] += 1
                return _real(*args, **kwargs)

            stack.enter_context(mock.patch.object(dist, name, counting))
        yield calls


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
    """Back to the weights `init` ((G, D) state dicts; a sharded state's
    shards refreshed from them), with fresh optimizers of `cfg`, at step
    0; the step graphs read the old optimizers, so they go (the gradients
    stay views of their flat buffers)."""
    with torch.no_grad():
        state.net_g.load_state_dict(init[0])
        state.net_d.load_state_dict(init[1])
    for shards in state.shards.values():
        shards.refresh()
    state.cfg, state.step = cfg, 0
    tstep.fresh_optimizers(state, cfg.train)
    if state.graphs is not None:
        state.graphs.clear()


def graph_counts(state):
    g = state.graphs
    return (0, 0) if g is None else (g.captures, g.replays)


def route(before, after) -> str:
    """How a step ran, from the graphs' (captures, replays) around it."""
    if after[0] > before[0]:
        return "capture"
    return "replay" if after[1] > before[1] else "eager"


def graph_report(state):
    """The state's step graphs: signatures, captures, replays, eager
    warm-up steps, graphs a step, capture seconds and the pool's bytes
    after each capture and now (None before the first routed step)."""
    g = state.graphs
    if g is None:
        return None
    return {"signatures": len(g.keys()), "captures": g.captures,
            "replays": g.replays, "eager_steps": g.eager_steps,
            "graphs_a_step": list(g.graphs_a_step.values()),
            "capture_seconds": list(g.capture_seconds.values()),
            "pool_bytes_at_capture": list(g.pool_bytes_at_capture.values()),
            "pool_bytes": g.pool_bytes()}


def mas_launches() -> int:
    """The DP kernels' launches so far: one a step, fused or two-pass."""
    return mas.launch_counts["mas_fused"] + mas.launch_counts["mas_fwd"]


REPLAYED = collections.Counter()  # this rank's MAS launches in replays


def train_step(state, batch, draws=None):
    """`train.step.train_step`, its MAS launches added to REPLAYED when it
    replayed the step's graphs."""
    before, n0 = graph_counts(state), dict(mas.launch_counts)
    metrics = tstep.train_step(state, batch, draws)
    if route(before, graph_counts(state)) == "replay":
        REPLAYED.update({k: mas.launch_counts[k] - n0[k] for k in n0})
    return metrics


def grad_views(state) -> dict:
    """Per net: whether every gradient lies in its flat buffer (a view of
    it, its first element inside the buffer's bytes), whether the views
    cover the buffer but its tail, and the parameters without one."""
    out = {}
    for name, net in (("g", state.net_g), ("d", state.net_d)):
        buf = state.grad_buffers[name]
        lo = buf.data_ptr()
        hi = lo + buf.numel() * buf.element_size()
        grads = [p.grad for p in net.parameters() if p.grad is not None]
        tail = 3 if name == "d" else 7
        out[name] = {
            "views": all(g._base is buf and lo <= g.data_ptr() < hi
                         for g in grads),
            "covered": sum(g.numel() for g in grads) == buf.numel() - tail,
            "without_grad": [k for k, p in net.named_parameters()
                             if p.grad is None]}
    return out


DEFAULT_ALGORITHMS = {"enabled": True}  # cuDNN's own choice, as training


def cudnn(setting):
    """cuDNN set as `setting` ({"enabled", "deterministic"}) with TF32 off:
    flags() would turn cuDNN's TF32 on unless told not to."""
    return torch.backends.cudnn.flags(
        enabled=setting.get("enabled", True),
        deterministic=setting.get("deterministic", False),
        benchmark=False, allow_tf32=False)


@contextlib.contextmanager
def algorithms(setting):
    """`cudnn(setting)` and, when it asks for determinism, torch's
    deterministic algorithms as well (warnings only where an op has
    none)."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    with cudnn(setting):
        if setting.get("deterministic"):
            torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(before[0],
                                               warn_only=before[1])


def leaves(state) -> dict:
    """A copy of every weight and buffer, as "g.<name>" and "d.<name>"."""
    return {f"{n}.{k}": v.detach().clone() for n, m in
            (("g", state.net_g), ("d", state.net_d))
            for k, v in m.state_dict().items()}


def reset_in_place(state, init) -> None:
    """Back to the weights `init` ((G, D) state dicts; a sharded state's
    shards refreshed from them) and to zero AdamW moments and counts, each
    written into the tensor the step graphs read."""
    with torch.no_grad():
        for net, sd in zip((state.net_g, state.net_d), init):
            for k, v in net.state_dict().items():
                v.copy_(sd[k])
        for shards in state.shards.values():
            shards.refresh()
        for optim in (state.optim_g, state.optim_d):
            for st in optim.state.values():
                for v in st.values():
                    v.zero_()


def distance(a, b, init_g, lr) -> dict:
    """Step a ((metrics, `leaves`)) against step b from the same weights
    (`init_g`, G's state dict): whether every metric and leaf is
    bit-equal (the unequal leaves counted, the four farthest by max-abs
    named), the loss scalars' largest relative difference, the D leaves'
    max-abs one, and the G leaves' updates (less their weight decay at
    `lr`) relative in L2: the worst leaf, and all of them as one vector
    (`g_update_rel_l2_all`), over the `g_leaves_compared` leaves whose
    update is not ~0."""
    (am, al), (bm, bl) = a, b
    keep = 1.0 - lr * tstep.WEIGHT_DECAY
    g_rel, worst, compared = 0.0, None, 0
    diff2 = size2 = 0.0  # squared norms over every compared leaf
    for k, v in bl.items():
        if not k.startswith("g."):
            continue
        p0 = init_g[k[2:]].double()
        upd = v.double() - keep * p0
        size = float(upd.norm())
        if size < 1e-6:
            continue
        diff = float((al[k].double() - keep * p0 - upd).norm())
        diff2, size2 = diff2 + diff ** 2, size2 + size ** 2
        if diff / size > g_rel:
            g_rel, worst = diff / size, k
        compared += 1
    unequal = sorted(((float((al[k] - v).abs().max()), k)
                      for k, v in bl.items() if not torch.equal(al[k], v)),
                     reverse=True)
    return {"bit_equal": am == bm and not unequal,
            "loss_rel": max(abs(am[k] - v) / max(abs(v), 1e-12)
                            for k, v in bm.items()
                            if k.startswith(("loss/", "grad_norm"))),
            "d_max_abs": max(float((al[k] - v).abs().max())
                             for k, v in bl.items() if k.startswith("d.")),
            "g_update_rel_l2": g_rel, "g_worst_leaf": worst,
            "g_update_rel_l2_all": (diff2 / size2) ** 0.5 if size2 else 0.0,
            "g_leaves_compared": compared, "unequal_leaves": len(unequal),
            "most_unequal": unequal[:4]}


def replay_vs_eager(state, batch, init, cfg, setting, repeats: int,
                    step: int = 0, capture: bool = True) -> dict:
    """A replayed step against the eager body (`train_step_eager`) from
    the same weights, under the cuDNN setting `setting` (`algorithms`),
    at `cfg`'s lr of step `step`. With `capture` the state first gets
    fresh optimizers of `cfg` (`reset`), its warm-up steps and its
    capture under `setting`; without, it replays the graphs it holds,
    which must have been captured under `setting` and `cfg`'s eps. Then,
    each from the weights `init` with zero moments (`reset_in_place`),
    at step `step`, dropout seed 11 and the state's own draws of that
    step: the replay, the eager step, and `repeats` more eager ones (how
    far the eager step is from itself). Returns the replay's and each
    repeat's `distance` from the eager step, the lr the replayed update
    read, whether every metric is finite, the replay's route and MAS
    launches, and the captures it took."""
    before = graph_counts(state)
    runs = []
    with algorithms(setting):
        if capture:
            reset(state, init, cfg)
            for _ in range(WARMUP_ITERS + 1):
                train_step(state, batch)
        state.cfg = cfg
        for fn in [train_step] + [tstep.train_step_eager] * (1 + repeats):
            reset_in_place(state, init)
            state.step = step
            lr = state.learning_rate()
            torch.cuda.manual_seed(11)
            n0, counts = mas_launches(), graph_counts(state)
            metrics = {k: float(v) for k, v in fn(state, batch).items()}
            _sync(state.device)
            runs.append(((metrics, leaves(state)), mas_launches() - n0,
                         route(counts, graph_counts(state)),
                         float(state.optim_g.param_groups[0]["lr"])))
    (replay, mas_replay, how, lr_read), eager = runs[0], runs[1][0]
    return {"cudnn": setting, "captured": capture, "replay_route": how,
            "graphs_a_step": list(state.graphs.graphs_a_step.values())[-1],
            "captures": graph_counts(state)[0] - before[0],
            "lr_in_replayed_update": lr_read,
            "metrics_finite": all(math.isfinite(v) for (m, _), *_ in runs
                                  for v in m.values()),
            "replay": distance(replay, eager, init[0], lr),
            "replay_mas_launches": mas_replay,
            "eager_repeats": [distance(r, eager, init[0], lr)
                              for r, *_ in runs[2:]]}


def profiled(state, batch, fn=train_step) -> dict:
    """One step of `fn` under `utils.timing.profile_call`, with trailing
    steps cut from the profile unless `fn` is the eager body (the
    profiler drops the device records of a profile's last graph
    replays). Adds what each MAS wrapper counted in that step
    (`mas_counted`; for a replay, its capture's counts: ops/mas.py's
    replay rule), their DP launches (`mas_launches`), and whether the
    profiler saw each of those kernels run on the card as many times
    (`mas_kernels_seen`)."""
    counts = []

    def one():
        counts.append(dict(mas.launch_counts))
        fn(state, batch)
        torch.cuda.synchronize()
        counts.append(dict(mas.launch_counts))

    prof = timing.profile_call(one, trailing=None if fn is
                               tstep.train_step_eager else lambda: (
                                   fn(state, batch), torch.cuda.synchronize()))
    counted = {k: counts[1][k] - counts[0][k] for k in counts[0]
               if counts[1][k] != counts[0][k]}
    seen = collections.Counter()
    for name, calls in prof["mas_kernels"].items():
        seen[re.search(r"\b(mas_\w+?)_kernel", name).group(1)] += calls
    return {**prof, "mas_counted": counted,
            "mas_launches": sum(counted.get(k, 0)
                                for k in ("mas_fused", "mas_fwd")),
            "mas_kernels_seen": dict(seen) == counted}


def timed_routes(state, batch, steps: int, synced: int = 0) -> dict:
    """The state (warm and captured) stepped through its graphs and
    eagerly: `synced` synced steps of each in turns (host ms each, MAS
    launches), then `steps` queued steps of each timed with CUDA events
    (ms a step), then one profiled step of each (`profiled`: launches,
    device ms and busy share, the MAS kernels the card ran)."""
    routes = {"graph": train_step, "eager": tstep.train_step_eager}
    host = {k: [] for k in routes}
    mas_per_step = {k: [] for k in routes}
    finite = True
    for _ in range(synced):
        for name, fn in routes.items():
            n0 = mas_launches()
            _sync(state.device)
            t0 = time.perf_counter()
            metrics = fn(state, batch)
            finite &= all(math.isfinite(float(v)) for v in metrics.values())
            host[name].append((time.perf_counter() - t0) * 1e3)
            mas_per_step[name].append(mas_launches() - n0)
    out = {}
    for name, fn in routes.items():
        _sync(state.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn(state, batch)
        end.record()
        _sync(state.device)
        out[name] = {"step_ms_events": start.elapsed_time(end) / steps}
    for name, fn in routes.items():
        prof = profiled(state, batch, fn)
        out[name].update(
            step_ms_host=host[name],
            step_ms_host_median=statistics.median(host[name])
            if host[name] else None,
            launches={k: prof[k] for k in (
                "cuda_launch_kernel_calls", "cuda_graph_launch_calls",
                "cuda_memcpy_calls")},
            device_ms=prof["device_ms"],
            device_busy_share=prof["device_busy_share"],
            wall_ms_profiled=prof["wall_ms_profiled"],
            mas_launches_per_step=mas_per_step[name] + [prof["mas_launches"]],
            mas_kernels_profiled=prof["mas_kernels"],
            mas_kernels_seen=prof["mas_kernels_seen"])
    out["metrics_finite"] = finite
    return out


def route_checks(spec, info, state, batch) -> dict:
    """The data-parallel route on this rank (tests/
    test_torch_port_ddp_graphs.py): `state` (sharded, never stepped)
    steps without draws, then saves (rank 0) and resumes its pair, and
    steps again, its gradients checked against its flat buffers after
    each; a twin from the same weights steps on `draw_step`'s rank-local
    draws; a state with an unused leaf steps twice; a plain state (no
    group) steps once. The all-reduce calls of each step are counted.
    With "bench", `bench_train` runs in this process group afterwards
    and its stdout is returned."""
    cfg, out = spec["cfg"], {}

    def counted(st, draws=None):
        torch.manual_seed(1)  # dropout
        with counting_collectives() as calls:
            metrics = tstep.train_step(st, batch, draws)
        return calls["all_reduce"], {k: float(v) for k, v in metrics.items()}

    out["all_reduces"], free = counted(state)
    out["views_after_step"] = grad_views(state)
    out["keys"] = state.graphs.keys()
    twin = dryrun.shard_state(seeded_state(cfg, info.device, spec["seed"]),
                              1)
    _, drawn = counted(twin, tstep.draw_step(twin, batch))
    out["drawn_equals_free"] = (
        drawn == free and dryrun.digest((twin.net_g, twin.net_d))
        == dryrun.digest((state.net_g, state.net_d)))
    del twin

    ckpt = os.path.join(spec["out"], "ckpt")
    if dist.get_rank() == 0:
        checkpoint.save(ckpt, state)
    dist.barrier()
    out["resumed"] = checkpoint.resume(ckpt, state)
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(ckpt)  # a pair: most of a GB at the tiny width
    out["views_after_resume"] = grad_views(state)
    counted(state)
    out["views_after_resume_and_step"] = grad_views(state)

    unused = seeded_state(cfg, info.device, spec["seed"])
    unused.net_g.unused = torch.nn.Parameter(torch.ones(4))
    unused.optim_g = tstep.make_optimizer(unused.net_g.parameters(),
                                          cfg.train)
    dryrun.shard_state(unused, 1)
    for _ in range(2):
        counted(unused)
    out["unused_leaf"] = {"grad_is_none": unused.net_g.unused.grad is None,
                          "unchanged": bool((unused.net_g.unused == 1).all()),
                          "views": grad_views(unused)}
    del unused

    plain = seeded_state(cfg, info.device, spec["seed"])
    out["plain_all_reduces"], _ = counted(plain)
    out["plain_keys"] = plain.graphs.keys()
    del plain
    if spec["checks"].get("bench"):
        text = io.StringIO()
        from mb_istft_vits_torch import bench_train

        with contextlib.redirect_stdout(text):
            bench_train.main(spec["checks"]["bench"])
        out["bench"] = text.getvalue()
    return out


DETERMINISTIC = {"enabled": True, "deterministic": True}


def tp_checks(spec, info, state, batch, init) -> dict:
    """The 2-D route on this rank (tests/test_torch_port_tp_graphs.py,
    chip_smoke.py): `state` (sharded) back to the weights `init` with
    fresh optimizers of "restart" (else "cfg"); whether it is routed, its
    stages; on a card its warm-up steps and capture; the collectives of
    one more step (a replay on a card) by name, that step's route, its
    keys and `n_model`; then, under the deterministic algorithms, a save
    (every rank; rank 0 writes the pair) and a step, a resume of that pair
    and the same step again: whether the two steps' metrics (finite) and
    weights are bit-equal (both steps start a fresh key's warm-ups: the
    graphs are dropped before the first, and the resume drops them)."""
    reset(state, init, spec.get("restart") or spec["cfg"])
    out = {"routed": tgraphs.routed(state),
           "stages": len(tstep.step_stages(state, batch))}
    for _ in range(WARMUP_ITERS + 1 if info.device.type == "cuda" else 0):
        train_step(state, batch)
    before = graph_counts(state)
    torch.manual_seed(1)  # dropout
    with counting_collectives() as calls:
        train_step(state, batch)
    out["collectives"] = dict(calls)
    out["counted_route"] = route(before, graph_counts(state))
    out["keys"], out["n_model"] = state.graphs.keys(), state.n_model

    ckpt = os.path.join(spec["out"], "tp_ckpt")

    def step():
        torch.manual_seed(2)
        metrics = {k: float(v) for k, v in train_step(state, batch).items()}
        return metrics, dryrun.digest((state.net_g, state.net_d))

    out["saved_at"] = state.step
    with algorithms(DETERMINISTIC):
        checkpoint.save(ckpt, state)
        dist.barrier()
        state.graphs.clear()
        uninterrupted = step()
        out["resumed"] = checkpoint.resume(ckpt, state)
        resumed = step()
        out["resumed_step_equals_uninterrupted"] = resumed == uninterrupted
        out["resumed_finite"] = all(math.isfinite(v)
                                    for v in resumed[0].values())
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(ckpt)
    return out


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
        if (timed or len(spec.get("compare", [{}])) > 1
                or spec.get("graph_compare") or "checks" in spec):
            init = tuple({k: v.detach().clone() for k, v in
                          net.state_dict().items()}
                         for net in (state.net_g, state.net_d))
        dryrun.shard_state(state, n_model)
        batch = dryrun.rank_rows(spec["batch"], state)
        draws = spec.get("draws")
        if draws is not None:
            draws = tstep.StepDraws(*(None if v is None else v.to(info.device)
                                      for v in draws))
        out = {"rank": rank, "steps": [], "seconds": {}}
        clock = [time.perf_counter()]

        def lap(part):  # the seconds since the last part ended
            now = time.perf_counter()
            out["seconds"][part], clock[0] = now - clock[0], now

        def step(draws):
            launches = mas_launches()
            before = graph_counts(state)
            _sync(info.device)
            t0 = time.perf_counter()
            metrics = train_step(state, batch, draws)
            metrics = {k: float(v) for k, v in metrics.items()}
            _sync(info.device)
            return {"host_ms": (time.perf_counter() - t0) * 1e3,
                    "metrics": metrics,
                    "mas_launches": mas_launches() - launches,
                    "route": route(before, graph_counts(state)),
                    "digest": dryrun.digest((state.net_g, state.net_d))}

        out["compared"], out["g"], out["d"] = [], [], []
        for i, setting in enumerate(spec.get("compare", [{}])):
            if i:
                reset(state, init, spec["cfg"])
            with cudnn(setting):
                out["compared"].append(step(draws))
            if i == 0 and n_model > 1:
                checkpoint.save(spec["out"], state)
            elif rank == 0:
                out["g"].append({k: v.detach().cpu().clone() for k, v in
                                 state.net_g.state_dict().items()})
                out["d"].append({k: v.detach().cpu().clone() for k, v in
                                 state.net_d.state_dict().items()})
        lap("set_up_and_compared")
        if timed:
            reset(state, init, spec["restart"])
            out["steps"] = [step(None) for _ in range(timed)]
        if spec.get("routes"):
            out["routes"] = timed_routes(state, batch, spec["routes"])
            out["routes"]["graphs"] = graph_report(state)
        lap("timed")
        # the timed steps' graphs were captured under cuDNN's default
        # algorithms: a compare under those replays them (at the compared
        # lr, in the optimizers of "restart", whose eps must be "cfg"'s);
        # one under other algorithms captures its own
        reuse = DEFAULT_ALGORITHMS if timed else None
        if (reuse in spec.get("graph_compare", ())
                and spec["restart"].train.eps != spec["cfg"].train.eps):
            raise ValueError("the timed steps' graphs hold another eps")
        out["graph_compare"] = [
            replay_vs_eager(state, batch, init, spec["cfg"], setting,
                            0 if setting.get("deterministic") else 1,
                            capture=setting != reuse)
            for setting in spec.get("graph_compare", ())]
        lap("graph_compare")
        if n_model > 1:
            out["sharded"] = shard_report(state)
        if "checks" in spec:
            out["checks"] = (tp_checks(spec, info, state, batch, init)
                             if n_model > 1 else
                             route_checks(spec, info, state, batch))
        out["launch_counts"] = dict(mas.launch_counts)
        out["replayed_launches"] = dict(REPLAYED)
        if info.device.type == "cuda":
            nbytes = 4 * sum(p.numel() for net in (state.net_g, state.net_d)
                             for p in net.parameters())
            out["allreduce_bytes"] = nbytes
            out["allreduce_ms"] = allreduce_ms(nbytes, info.device)
        torch.save(out, os.path.join(spec["out"], f"{rank}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
