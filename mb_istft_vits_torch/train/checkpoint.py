"""Trainer checkpoints in the reference's format (reference
`utils.py:22-79`): `G_{step}.pth` and `D_{step}.pth` in the model
directory, each {"model": state dict, "iteration", "optimizer": the
AdamW state dict, "learning_rate"}. A reference loader reads them as they
are; "iteration" holds the global step (the reference writes its epoch
there), which is what `resume` restarts from.

Beyond the reference, as in `mb_istft_vits_tpu/train/checkpoint.py`:
`prune` bounds a long run's disk (keep the newest pairs, milestones and
the best-by-eval step), `record_best` / `best_step` keep which pair is
best by evaluation (`best.json` beside the pairs), and `snap_to_epoch`
moves a resumed run back to its last finished epoch.

The optimizer state is written in the form a CPU AdamW holds (float lr,
not capturable, step counts on the CPU), whatever optimizer wrote it, so
a pair written by a card's capturable optimizer loads into an eager CPU
state and the reverse; loading keeps the state's own lr tensor and
capturable flag, and puts its step counts where its update reads them.
"""

from __future__ import annotations

import json
import os
import re
from typing import Iterable, List, Optional

import torch

from mb_istft_vits_torch.train.step import TrainState, make_lr_schedule

BEST = "best.json"


def _path(model_dir: str, prefix: str, step: int) -> str:
    return os.path.join(model_dir, f"{prefix}_{step}.pth")


def save(model_dir: str, state: TrainState) -> None:
    """Write G_{step}.pth and D_{step}.pth (D first, so a G file means
    the pair is complete; each through a temporary name). The plain
    modules' state dicts: a data-parallel run's rank 0 calls this, and the
    names carry no DDP prefix. A sharded state (`parallel.tp`) holds its
    weights whole; its AdamW moments are gathered whole over "model", a
    collective every rank enters, and rank 0 writes the pair."""
    # the lr of the last step taken
    lr = make_lr_schedule(state.cfg)(
        max(state.step - 1 - state.lr_offset, 0))
    for prefix, net, optim in (("D", state.net_d, state.optim_d),
                               ("G", state.net_g, state.optim_g)):
        model, optim_sd = net.state_dict(), optim.state_dict()
        shards = state.shards.get(prefix.lower())
        if shards is not None:
            optim_sd = shards.whole_optimizer_state(optim_sd)
            if torch.distributed.get_rank() != 0:
                continue
        os.makedirs(model_dir, exist_ok=True)
        path = _path(model_dir, prefix, state.step)
        torch.save({"model": model, "iteration": state.step,
                    "optimizer": _portable(optim_sd), "learning_rate": lr},
                   path + ".tmp")
        os.replace(path + ".tmp", path)


def _portable(optim_sd: dict) -> dict:
    """An AdamW state dict in a CPU AdamW's form: each group's lr a float
    and capturable off, each step count a CPU tensor."""
    return {
        "state": {i: {k: v.detach().cpu()
                      if k == "step" and isinstance(v, torch.Tensor) else v
                      for k, v in st.items()}
                  for i, st in optim_sd["state"].items()},
        "param_groups": [dict(g, lr=float(g["lr"]), capturable=False)
                         for g in optim_sd["param_groups"]],
    }


def load_optimizer(optim: torch.optim.Optimizer, optim_sd: dict) -> None:
    """`optim.load_state_dict(optim_sd)`, keeping `optim`'s own lr tensor
    (filled with the saved lr) and capturable flag, with the step counts
    on the parameters' device when it is capturable. The moments are new
    tensors: a CUDA graph that read the old ones must be dropped."""
    kept = [(g["lr"], g.get("capturable", False))
            for g in optim.param_groups]
    optim.load_state_dict(optim_sd)
    for group, (lr, capturable) in zip(optim.param_groups, kept):
        if isinstance(lr, torch.Tensor):
            lr.fill_(float(group["lr"]))
            group["lr"] = lr
        group["capturable"] = capturable
        for p in group["params"]:
            st = optim.state.get(p, {})
            if isinstance(st.get("step"), torch.Tensor):
                st["step"] = st["step"].to(
                    p.device if capturable else torch.device("cpu"),
                    torch.float32)


def saved_steps(model_dir: str) -> List[int]:
    """Steps with both G and D checkpoints, ascending."""
    if not os.path.isdir(model_dir):
        return []
    steps = [int(m.group(1)) for name in os.listdir(model_dir)
             if (m := re.fullmatch(r"G_(\d+)\.pth", name))]
    return sorted(s for s in steps
                  if os.path.exists(_path(model_dir, "D", s)))


def latest_step(model_dir: str) -> Optional[int]:
    """The newest step with both G and D checkpoints, or None."""
    steps = saved_steps(model_dir)
    return steps[-1] if steps else None


def prune(model_dir: str, keep_last: int = 3, keep_every: int = 25000,
          keep_steps: Iterable[int] = ()) -> List[int]:
    """Delete the G/D pairs of every step but the newest `keep_last`,
    the multiples of `keep_every` and `keep_steps` (the trainer passes
    the best-by-eval step); the newest pair is always kept. A flagship
    pair is ~0.9 GB with both optimizers' moments, and a long run saves
    one every `eval_interval` steps (JAX `prune_checkpoints`). Each pair
    goes G first, so a half-deleted pair never reads as complete.
    Returns the pruned steps."""
    steps = saved_steps(model_dir)
    keep = set(steps[-keep_last:] if keep_last else []) | set(steps[-1:])
    if keep_every:
        keep.update(s for s in steps if s % keep_every == 0)
    keep.update(int(s) for s in keep_steps)
    pruned = [s for s in steps if s not in keep]
    for s in pruned:
        for prefix in "GD":
            os.remove(_path(model_dir, prefix, s))
    return pruned


def record_best(model_dir: str, step: int, metric: str, value: float
                ) -> None:
    """Record step as the best-by-eval pair (lower `value` is better) in
    model_dir/best.json, written atomically (JAX
    `record_best_checkpoint`)."""
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, BEST)
    with open(path + ".tmp", "w") as f:
        json.dump({"step": int(step), "metric": metric,
                   "value": float(value)}, f)
    os.replace(path + ".tmp", path)


def best_step(model_dir: str) -> Optional[dict]:
    """The recorded best-by-eval pair ({step, metric, value}), or None;
    None as well when that pair is no longer on disk."""
    try:
        with open(os.path.join(model_dir, BEST)) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    if int(rec.get("step", -1)) not in saved_steps(model_dir):
        return None
    return rec


def _adam_steps(optim: torch.optim.Optimizer) -> Optional[int]:
    """The optimizer's own step count (AdamW keeps one per parameter),
    or None before its first step."""
    steps = [int(s["step"]) for s in optim.state.values() if "step" in s]
    return max(steps) if steps else None


def resume(model_dir: str, state: TrainState,
           weights_only: bool = False) -> Optional[int]:
    """Load the newest checkpoint pair into `state`: the weights, the
    step and, unless `weights_only`, the optimizers' moments and counts.
    `weights_only` (the CLI's --reset-optimizer, the reference's
    train_latest_fixed.py:117-128) keeps fresh optimizers, so the lr
    schedule starts again from the initial lr while the step keeps the
    data order. Returns the step, or None when there is no pair.

    The weights are copied into the parameters in place (a sharded
    state's shards then refreshed from them, in place), so the state's
    step graphs (`train.graphs`) stay valid when only they load; loading
    the optimizers replaces their moments (a sharded state's cut to its
    shards), and drops the graphs."""
    step = latest_step(model_dir)
    if step is None:
        return None
    for prefix, net, optim in (("G", state.net_g, state.optim_g),
                               ("D", state.net_d, state.optim_d)):
        ckpt = torch.load(_path(model_dir, prefix, step),
                          map_location=state.device, weights_only=True)
        net.load_state_dict(ckpt["model"])
        shards = state.shards.get(prefix.lower())
        if shards is not None:
            shards.refresh()
        if not weights_only:
            load_optimizer(optim, ckpt["optimizer"] if shards is None else
                           shards.shard_optimizer_state(ckpt["optimizer"]))
    if not weights_only and state.graphs is not None:
        state.graphs.clear()
    state.step = step
    _sync_lr_offset(state)
    return step


def _sync_lr_offset(state: TrainState) -> None:
    """lr_offset = the steps the optimizers have not taken: 0 after a
    plain resume, the step itself after a reset."""
    state.lr_offset = state.step - (_adam_steps(state.optim_g) or 0)


def snap_to_epoch(state: TrainState, steps_per_epoch: int) -> int:
    """Move a resumed state back to the last finished epoch's boundary,
    where the reference's epoch loop restarts (JAX `train.py:404-425`):
    the step and every AdamW parameter's step count go back by the same
    number of steps (JAX `retime_opt_state`), so the lr and the bias
    correction stay with the replayed data (fresh optimizers, after
    --reset-optimizer, have no count to move). The counts are written in
    place, where the step graphs read them. Returns the new step."""
    back = state.step % max(steps_per_epoch, 1)
    if back:
        state.step -= back
        for optim in (state.optim_g, state.optim_d):
            for s in optim.state.values():
                if "step" in s:
                    s["step"] -= back  # in place on a tensor
        _sync_lr_offset(state)
    return state.step
