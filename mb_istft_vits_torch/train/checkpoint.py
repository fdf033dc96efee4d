"""Trainer checkpoints in the reference's format (reference
`utils.py:22-79`): `G_{step}.pth` and `D_{step}.pth` in the model
directory, each {"model": state dict, "iteration", "optimizer": the
AdamW state dict, "learning_rate"}. A reference loader reads them as they
are; "iteration" holds the global step (the reference writes its epoch
there), which is what `resume` restarts from.

Pruning and best-by-eval selection (`mb_istft_vits_tpu/train/
checkpoint.py`) are not ported yet.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from mb_istft_vits_torch.train.step import TrainState, make_lr_schedule


def _path(model_dir: str, prefix: str, step: int) -> str:
    return os.path.join(model_dir, f"{prefix}_{step}.pth")


def save(model_dir: str, state: TrainState) -> None:
    """Write G_{step}.pth and D_{step}.pth (D first, so a G file means
    the pair is complete; each through a temporary name)."""
    os.makedirs(model_dir, exist_ok=True)
    lr = make_lr_schedule(state.cfg.train)(max(state.step - 1, 0))
    for prefix, net, optim in (("D", state.net_d, state.optim_d),
                               ("G", state.net_g, state.optim_g)):
        path = _path(model_dir, prefix, state.step)
        torch.save({"model": net.state_dict(), "iteration": state.step,
                    "optimizer": optim.state_dict(), "learning_rate": lr},
                   path + ".tmp")
        os.replace(path + ".tmp", path)


def latest_step(model_dir: str) -> Optional[int]:
    """The newest step with both G and D checkpoints, or None."""
    if not os.path.isdir(model_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(model_dir)
             if (m := re.fullmatch(r"G_(\d+)\.pth", name))]
    steps = [s for s in steps if os.path.exists(_path(model_dir, "D", s))]
    return max(steps) if steps else None


def resume(model_dir: str, state: TrainState) -> Optional[int]:
    """Load the newest checkpoint pair into `state` (weights, optimizer
    moments, step). Returns its step, or None when there is none."""
    step = latest_step(model_dir)
    if step is None:
        return None
    for prefix, net, optim in (("G", state.net_g, state.optim_g),
                               ("D", state.net_d, state.optim_d)):
        ckpt = torch.load(_path(model_dir, prefix, step),
                          map_location=state.device, weights_only=True)
        net.load_state_dict(ckpt["model"])
        optim.load_state_dict(ckpt["optimizer"])
    state.step = step
    return step
