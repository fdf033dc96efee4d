"""Duration predictors: the deterministic conv stack and the stochastic
flow-based one (counterpart of `mb_istft_vits_tpu/models/duration.py`;
reference `models.py:22-137`). Both stop gradients into the text
encoder's hidden states (reference models.py:56,124)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mb_istft_vits_torch.nn import (
    Conv1d,
    ConvFlow,
    DDSConv,
    ElementwiseAffine,
    Flip,
    LayerNorm,
    Log,
    flip_channels,
)
from mb_istft_vits_torch.nn.layers import scale

_LOG_2PI = math.log(2 * math.pi)


class DurationPredictor(nn.Module):
    """conv-relu-LN-dropout x2 -> 1-channel log-duration. Gradients do not
    flow back into the text encoder (reference models.py:124). The speaker
    conditioning is a plain 1x1 `cond` conv added to the detached input;
    as in the JAX package (`models/duration.py:39-41`), g itself is not
    detached."""

    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float, gin_channels: int = 0):
        super().__init__()
        pad = kernel_size // 2
        self.drop = nn.Dropout(p_dropout)
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size,
                             padding=pad)
        self.norm_1 = LayerNorm(filter_channels)
        self.conv_2 = Conv1d(filter_channels, filter_channels, kernel_size,
                             padding=pad)
        self.norm_2 = LayerNorm(filter_channels)
        self.proj = Conv1d(filter_channels, 1, 1)
        self.cond = Conv1d(gin_channels, in_channels, 1) if gin_channels \
            else None

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, H, T], x_mask [B, 1, T], g [B, gin, 1] or None ->
        logw [B, 1, T]."""
        x = x.detach()
        if g is not None and self.cond is not None:
            x = x + self.cond(g)
        x = self.drop(self.norm_1(torch.relu(self.conv_1(x * x_mask))))
        x = self.drop(self.norm_2(torch.relu(self.conv_2(x * x_mask))))
        return self.proj(x * x_mask) * x_mask


def _flows_forward(flows: nn.ModuleList, z: torch.Tensor,
                   x_mask: torch.Tensor, g: torch.Tensor):
    """[ElementwiseAffine, (ConvFlow, Flip) x n] forward -> (z, logdet)."""
    z, logdet = flows[0](z, x_mask)
    for flow in flows[1:]:
        if isinstance(flow, Flip):
            z = flow(z)
        else:
            z, ld = flow(z, x_mask, g)
            logdet = logdet + ld
    return z, logdet


class StochasticDurationPredictor(nn.Module):
    """Flow-based duration model (reference models.py:22-100):
    `forward(reverse=False)` is the per-item NLL of the durations w plus
    the variational log q [B]; `forward(reverse=True)` samples logw
    [B, 1, T] from noise.

    `filter_channels` is overridden to `in_channels` (reference
    models.py:25). The ModuleLists keep the reference's state-dict layout:
    `flows` = [ElementwiseAffine, ConvFlow, Flip, ConvFlow, Flip, ...], so
    ConvFlow i is `flows.{1 + 2 i}`; `post_flows` likewise with four. The
    reverse chain drops the first ConvFlow ("remove a useless vflow",
    models.py:93-94). Dropout (p_dropout in `convs` and `post_convs`, none
    inside the ConvFlows) follows `self.training`.

    The draws are explicit: `noise` [B, 2, T] is the NLL's posterior noise
    e_q or the reverse's z (unit normal; the reverse scales it by
    `noise_scale`); without it, it is drawn from `noise_rng`."""

    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        fc = in_channels  # reference models.py:25
        self.n_flows = n_flows
        self.log_flow = Log()

        def chain(n):
            flows = nn.ModuleList([ElementwiseAffine(2)])
            for _ in range(n):
                flows.append(ConvFlow(2, fc, kernel_size, n_layers=3))
                flows.append(Flip())
            return flows

        self.flows = chain(n_flows)
        self.post_pre = Conv1d(1, fc, 1)
        self.post_proj = Conv1d(fc, fc, 1)
        self.post_convs = DDSConv(fc, kernel_size, 3, p_dropout=p_dropout)
        self.post_flows = chain(4)
        self.pre = Conv1d(in_channels, fc, 1)
        self.proj = Conv1d(fc, fc, 1)
        self.convs = DDSConv(fc, kernel_size, 3, p_dropout=p_dropout)
        self.cond = Conv1d(gin_channels, fc, 1) if gin_channels else None

    def _text(self, x, x_mask, g):
        """The detached text states through pre, cond, convs, proj."""
        x = self.pre(x.detach())
        if g is not None and self.cond is not None:
            x = x + self.cond(g)
        return self.proj(self.convs(x, x_mask)) * x_mask

    @staticmethod
    def _noise(noise, like: torch.Tensor, generator) -> torch.Tensor:
        """`noise`, or a unit draw from `generator` taken as JAX lays it
        out, [B, T, 2] (so a draw of the caller's equals this one)."""
        if noise is not None:
            return noise.to(like.dtype)
        b, _, t = like.shape
        return torch.randn((b, t, 2), generator=generator, dtype=like.dtype,
                           device=like.device).transpose(1, 2)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                w: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None, reverse: bool = False,
                noise_scale: float = 1.0,
                noise_rng: Optional[torch.Generator] = None, *,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, H, T] text states, x_mask [B, 1, T], w [B, 1, T] frame
        counts (the NLL's target), g [B, gin, 1] or None -> the NLL [B]
        (`nll`) or, reversed, logw [B, 1, T] sampled from the noise z
        [B, 2, T] times `noise_scale`. The noise is `noise`, else drawn
        from `noise_rng` (JAX's key slot: a `torch.Generator`)."""
        if not reverse:
            return self.nll(x, x_mask, w, g, noise_rng, noise=noise)
        x = self._text(x, x_mask, g)
        z = scale(self._noise(noise, x, noise_rng), noise_scale)
        for i in range(self.n_flows - 1, 0, -1):
            z = self.flows[1 + 2 * i](flip_channels(z), x_mask, x,
                                      reverse=True)
        z = self.flows[0](flip_channels(z), x_mask, reverse=True)
        return z[:, :1]

    def nll(self, x: torch.Tensor, x_mask: torch.Tensor, w: torch.Tensor,
            g: Optional[torch.Tensor] = None,
            noise_rng: Optional[torch.Generator] = None, *,
            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The training NLL [B] of the durations w [B, 1, T] plus the
        variational log q (reference models.py:64-91); `noise` [B, 2, T]
        is the posterior noise e_q, else drawn from `noise_rng`."""
        x = self._text(x, x_mask, g)
        # variational posterior of the dequantization u and of z1
        # (reference models.py:64-84)
        h_w = self.post_proj(self.post_convs(self.post_pre(w), x_mask))
        h_w = h_w * x_mask
        e_q = self._noise(noise, x, noise_rng) * x_mask
        z_q, logdet_q = _flows_forward(self.post_flows, e_q, x_mask, x + h_w)
        z_u, z1 = z_q[:, :1], z_q[:, 1:]
        u = torch.sigmoid(z_u) * x_mask
        z0 = (w - u) * x_mask
        logdet_q = logdet_q + torch.sum(
            (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, dim=(1, 2))
        logq = torch.sum(-0.5 * (_LOG_2PI + e_q ** 2) * x_mask,
                         dim=(1, 2)) - logdet_q

        # the main flows' NLL of [log(w - u), z1] (models.py:86-91)
        z0, logdet = self.log_flow(z0, x_mask)
        z, ld = _flows_forward(self.flows, torch.cat([z0, z1], dim=1),
                               x_mask, x)
        nll = torch.sum(0.5 * (_LOG_2PI + z ** 2) * x_mask,
                        dim=(1, 2)) - (logdet + ld)
        return nll + logq
