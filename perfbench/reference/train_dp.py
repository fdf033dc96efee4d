"""The published GAN training step over data-parallel ranks, in plain
PyTorch: the reference code's `train_ms.py` run as one process a card,
each rank stepping on its own rows of the global batch and DDP averaging
the gradients. Here one process computes every rank's part and sums: each
rank's chunk is forwarded under that rank's dropout seed
(`reference.train.forward`), the discriminator's loss is the mean of the
ranks' losses, and the generator's is the global batch's: its mean terms
(adversarial, feature matching, mel, sub-band) the mean of the ranks',
its duration and KL terms each rank's sum over the global batch's mask
sum (sum(x_mask) and sum(z_mask) over all ranks), as the published losses
compute them on the whole batch. One backward of each sum gives the
gradient that the ranks' all-reduce averages; the generator's is then
value-clipped and both take AdamW (`reference.train`). Imports nothing of
the measured program."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from perfbench.reference import train

MEAN_TERMS = ("gen", "fm", "mel", "subband")


class DataParallelTrainer(train.Trainer):
    """The reference's training state, stepped over every rank's chunk."""

    def step_ranks(self, chunks: Sequence[tuple], lr: float,
                   seeds: Sequence[int]) -> Dict[str, object]:
        """One step over the ranks' chunks [(batch, draws), ...], rank r
        forwarded after seeding the dropout generator with seeds[r].
        Returns the global batch's losses (floats) and the gradients as
        the optimizers took them (the generator's after the clip)."""
        world = len(chunks)
        outs = []
        for (batch, draws), seed in zip(chunks, seeds):
            train._seed_dropout(seed, batch["x"].device)
            outs.append(train.forward(self.pg, self.cfg, batch, draws))
        loss_d = sum(train.d_loss(self.pd, o["y"], o["y_hat"].detach())
                     for o in outs) / world
        grads_d = train._grads(loss_d, self.pd)
        self.opt_d.step(grads_d, lr)
        pd = {k: v.detach() for k, v in self.pd.items()}
        x_sums = [b["x_lengths"].float().sum() for b, _ in chunks]
        y_sums = [b["spec_lengths"].float().sum() for b, _ in chunks]
        x_all, y_all = sum(x_sums), sum(y_sums)
        losses: Dict[str, torch.Tensor] = {}
        for o, xs, ys in zip(outs, x_sums, y_sums):
            terms = train.g_losses(self.pg, pd, self.cfg, o)
            for k, v in terms.items():
                share = (1.0 / world if k in MEAN_TERMS
                         else (xs / x_all if k == "dur" else ys / y_all))
                losses[k] = losses.get(k, 0.0) + v * share
        total = sum(losses.values())
        grads_g = train._grads(total, self.pg)
        clip = self.cfg["train"].get("grad_clip_value", 1.0)
        grads_g = {k: g.clamp(-clip, clip) for k, g in grads_g.items()}
        self.opt_g.step(grads_g, lr)
        values = {"d/total": float(loss_d.detach()),
                  "g/total": float(total.detach())}
        values.update({f"g/{k}": float(v.detach()) for k, v in losses.items()})
        return {"losses": values, "grads": {
            **{"g." + k: v for k, v in grads_g.items()},
            **{"d." + k: v for k, v in grads_d.items()}}}


def run(cfg, g_weights, d_weights, steps: List[Sequence[tuple]],
        lrs: List[float], dropout_seeds: List[Sequence[int]]):
    """`reference.train.run` over ranks: steps[k] holds each rank's
    (batch, draws) of step k, dropout_seeds[k] each rank's seed. Returns
    the global losses of each step, the first step's gradient norms by
    leaf, and each leaf's change over the steps."""
    trainer = DataParallelTrainer(cfg, g_weights, d_weights)
    start = {k: v.clone() for k, v in trainer.weights().items()}
    losses, first = [], None
    for chunks, lr, seeds in zip(steps, lrs, dropout_seeds):
        res = trainer.step_ranks(chunks, lr, seeds)
        losses.append(res["losses"])
        if first is None:
            first = {k: float(v.double().norm()) for k, v in
                     res["grads"].items()}
    end = trainer.weights()
    change = {k: float((end[k].double() - start[k].double()).norm())
              for k in start}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def replay(cfg, g_weights, d_weights, d_moments: Dict[str, tuple],
           d_step: int, chunks: Sequence[tuple], lr: float,
           seeds: Sequence[int]) -> Dict[str, float]:
    """`reference.train.replay` over ranks: the global losses of one step
    from a state taken mid-run."""
    trainer = DataParallelTrainer(cfg, g_weights, d_weights)
    for k, (m, v) in d_moments.items():
        trainer.opt_d.m[k].copy_(m)
        trainer.opt_d.v[k].copy_(v)
    trainer.opt_d.t = d_step
    return trainer.step_ranks(chunks, lr, seeds)["losses"]
