"""The published GAN training step in plain PyTorch (the reference code's
`train_latest.py`): one generator forward (posterior, flow, MAS,
duration loss, random decode slice), a discriminator step on the real
and detached fake slices, then a generator step against the updated
discriminator, both with AdamW (weight decay 0.01), the generator's
gradients value-clipped. Functions of weight dicts; imports nothing of the
measured program.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from perfbench.reference import vits

WEIGHT_DECAY = 0.01
DP_DROPOUT = 0.5  # the duration predictor's, fixed by the published model


class AdamW:
    """Decoupled AdamW, one leaf at a time, as published (Loshchilov and
    Hutter 2019): p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)."""

    def __init__(self, params: Dict[str, torch.Tensor], betas, eps):
        self.params, self.betas, self.eps = params, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads.get(k)
                if g is None:
                    continue
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                p.mul_(1 - lr * WEIGHT_DECAY)
                denom = (self.v[k] / c2).sqrt_().add_(self.eps)
                p.addcdiv_(self.m[k], denom, value=-lr / c1)


def _grads(loss, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    names = list(params)
    got = torch.autograd.grad(loss, [params[k] for k in names],
                              allow_unused=True)
    return {k: g for k, g in zip(names, got) if g is not None}


def slice_frames(x, ids, size):
    """x [B, C, T] -> [B, C, size] from each row's start."""
    idx = ids.long()[:, None] + torch.arange(size, device=x.device)
    return x.gather(2, idx[:, None].expand(x.shape[0], x.shape[1], size))


def forward(pg, cfg, batch, draws):
    """The generator forward of a training step. batch: x, x_lengths, wav
    (int16 [B, T_wav, 1]), spec_lengths, sid (or absent). draws: the
    posterior noise [B, C, T_spec] and the slice starts [B]."""
    m, d = cfg["model"], cfg["data"]
    wav = batch["wav"].float()[..., 0] / d["max_wav_value"]
    t_spec = (wav.shape[1] - (d["filter_length"] - d["hop_length"])) \
        // d["hop_length"]
    spec = vits.linear_spectrogram(wav, d["filter_length"], d["hop_length"],
                                   d["win_length"])[:, :, :t_spec]
    sid = batch.get("sid")
    g = pg["emb_g.weight"][sid.long()][:, :, None] if sid is not None \
        else None
    h, m_p, logs_p, x_mask = vits.text_encoder(pg, m, batch["x"].long(),
                                               batch["x_lengths"], True)
    z, m_q, logs_q, y_mask = vits.posterior(pg, spec, batch["spec_lengths"],
                                            g, draws["posterior_eps"])
    z_p = vits.flow(pg, z, y_mask, g)
    with torch.no_grad():
        nc = vits.neg_cent(z_p.detach(), m_p.detach(), logs_p.detach())
        attn = vits.maximum_path(nc, batch["spec_lengths"].tolist(),
                                 batch["x_lengths"].tolist())
    w = attn.sum(dim=1, keepdim=True)
    logw_ = torch.log(w + 1e-6) * x_mask
    logw = vits.duration_predictor(pg, h, x_mask, g, DP_DROPOUT, True)
    l_length = torch.sum((logw - logw_) ** 2, dim=(1, 2)) / torch.sum(x_mask)
    m_p = m_p @ attn.transpose(1, 2)
    logs_p = logs_p @ attn.transpose(1, 2)
    seg = cfg["train"]["segment_size"] // d["hop_length"]
    ids = draws["ids_slice"]
    y_hat, y_hat_mb = vits.decoder(pg, m, slice_frames(z, ids, seg), g)
    y = slice_frames(wav[:, None], ids * d["hop_length"],
                     cfg["train"]["segment_size"])
    return dict(y=y, y_hat=y_hat, y_hat_mb=y_hat_mb, spec=spec, ids=ids,
                l_length=l_length, z_p=z_p, m_p=m_p, logs_p=logs_p,
                logs_q=logs_q, y_mask=y_mask, seg=seg)


def d_loss(pd, y, y_hat):
    scores, _ = vits.discriminator(pd, torch.cat([y, y_hat]))
    b = y.shape[0]
    return sum(torch.mean((1 - s[:b]) ** 2) + torch.mean(s[b:] ** 2)
               for s in scores)


def g_losses(pg, pd, cfg, out):
    d, t = cfg["data"], cfg["train"]
    y, y_hat = out["y"], out["y_hat"]
    b = y.shape[0]
    scores, fmaps = vits.discriminator(pd, torch.cat([y, y_hat]))
    with torch.no_grad():
        y_mel = vits.log_mel(slice_frames(out["spec"], out["ids"],
                                          out["seg"]), d)
    y_hat_mel = vits.log_mel(vits.linear_spectrogram(
        y_hat[:, 0], d["filter_length"], d["hop_length"], d["win_length"]), d)
    z_p, logs_q, m_p, logs_p = (out[k] for k in ("z_p", "logs_q", "m_p",
                                                 "logs_p"))
    kl = logs_p - logs_q - 0.5 + 0.5 * (z_p - m_p) ** 2 * torch.exp(
        -2.0 * logs_p)
    losses = {
        "gen": sum(torch.mean((1 - s[b:]) ** 2) for s in scores),
        "fm": 2 * sum(torch.mean(torch.abs(f[:b].detach() - f[b:]))
                      for fm in fmaps for f in fm),
        "mel": torch.mean(torch.abs(y_mel - y_hat_mel)) * t["c_mel"],
        "dur": torch.sum(out["l_length"]),
        "kl": torch.sum(kl * out["y_mask"]) / torch.sum(out["y_mask"])
        * t["c_kl"],
    }
    if cfg["model"]["mb_istft_vits"]:
        y_mb = vits.pqmf_analysis(y, cfg["model"]["subbands"])
        real = y_mb.reshape(-1, y_mb.shape[-1])
        fake = out["y_hat_mb"].reshape(-1, out["y_hat_mb"].shape[-1])
        n = min(real.shape[-1], fake.shape[-1])
        sc = mag = 0.0
        for fs, hs, wl in zip(t["fft_sizes"], t["hop_sizes"],
                              t["win_lengths"]):
            xm = vits.magnitude(fake[:, :n], fs, hs, wl, True, eps=1e-7)
            ym = vits.magnitude(real[:, :n], fs, hs, wl, True, eps=1e-7)
            sc = sc + torch.linalg.norm(ym - xm) / torch.linalg.norm(ym)
            mag = mag + torch.mean(torch.abs(torch.log(ym) - torch.log(xm)))
        k = len(t["fft_sizes"])
        losses["subband"] = sc / k + mag / k
    return losses


class Trainer:
    """The reference's training state: both weight dicts (leaves that
    require gradients) and their optimizers."""

    def __init__(self, cfg, g_weights, d_weights):
        t = cfg["train"]
        self.cfg = cfg
        self.pg = {k: v.detach().clone().float().requires_grad_(True)
                   for k, v in g_weights.items()}
        self.pd = {k: v.detach().clone().float().requires_grad_(True)
                   for k, v in d_weights.items()}
        self.opt_g = AdamW(self.pg, tuple(t["betas"]), t["eps"])
        self.opt_d = AdamW(self.pd, tuple(t["betas"]), t["eps"])

    def step(self, batch, draws, lr: float) -> Dict[str, object]:
        """One step; returns the losses (floats) and the gradients as the
        optimizers took them (the generator's after the clip)."""
        out = forward(self.pg, self.cfg, batch, draws)
        loss_d = d_loss(self.pd, out["y"], out["y_hat"].detach())
        grads_d = _grads(loss_d, self.pd)
        self.opt_d.step(grads_d, lr)
        pd = {k: v.detach() for k, v in self.pd.items()}
        losses = g_losses(self.pg, pd, self.cfg, out)
        total = sum(losses.values())
        grads_g = _grads(total, self.pg)
        clip = self.cfg["train"].get("grad_clip_value", 1.0)
        grads_g = {k: g.clamp(-clip, clip) for k, g in grads_g.items()}
        self.opt_g.step(grads_g, lr)
        values = {"d/total": float(loss_d.detach()),
                  "g/total": float(total.detach())}
        values.update({f"g/{k}": float(v.detach()) for k, v in losses.items()})
        return {"losses": values, "grads": {**{"g." + k: v for k, v in
                                               grads_g.items()},
                                            **{"d." + k: v for k, v in
                                               grads_d.items()}}}

    def weights(self) -> Dict[str, torch.Tensor]:
        return {**{"g." + k: v.detach() for k, v in self.pg.items()},
                **{"d." + k: v.detach() for k, v in self.pd.items()}}


def run(cfg, g_weights, d_weights, steps: List[tuple], lrs: List[float],
        dropout_seeds: List[int]):
    """The reference's first steps from the given weights. steps: (batch,
    draws) per step; the dropout generator is seeded with dropout_seeds[i]
    before step i, on the batch's device. Returns the losses of each
    step, the first step's gradients' norms by leaf, and each leaf's
    change over the steps' norm (float64 values)."""
    trainer = Trainer(cfg, g_weights, d_weights)
    start = {k: v.clone() for k, v in trainer.weights().items()}
    losses, first = [], None
    for (batch, draws), lr, seed in zip(steps, lrs, dropout_seeds):
        _seed_dropout(seed, batch["x"].device)
        res = trainer.step(batch, draws, lr)
        losses.append(res["losses"])
        if first is None:
            first = {k: float(v.double().norm()) for k, v in
                     res["grads"].items()}
    end = trainer.weights()
    change = {k: float((end[k].double() - start[k].double()).norm())
              for k in start}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def replay(cfg, g_weights, d_weights, d_moments: Dict[str, tuple],
           d_step: int, batch, draws, lr: float, seed: int
           ) -> Dict[str, float]:
    """The losses of one step from a state taken mid-run: the weights,
    and the discriminator's AdamW moments {leaf: (m, v)} after `d_step`
    steps (the generator's adversarial and feature-matching terms read
    the discriminator after its update). The dropout generator is seeded
    with `seed` before the step."""
    trainer = Trainer(cfg, g_weights, d_weights)
    for k, (m, v) in d_moments.items():
        trainer.opt_d.m[k].copy_(m)
        trainer.opt_d.v[k].copy_(v)
    trainer.opt_d.t = d_step
    _seed_dropout(seed, batch["x"].device)
    return trainer.step(batch, draws, lr)["losses"]


def _seed_dropout(seed: int, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.manual_seed(seed)
    else:
        torch.manual_seed(seed)
