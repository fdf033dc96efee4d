"""Normalizing-flow layers: Log, Flip, ElementwiseAffine, the affine
residual coupling of the prior flow and the spline ConvFlow of the
stochastic duration predictor (counterpart of
`mb_istft_vits_tpu/nn/flows.py`; reference `modules.py:269-400`). Flip
reverses the channel axis of [B, C, T]; the speaker conditioning g of the
coupling is [B, gin, 1], ConvFlow's g is [B, filter_channels, T].

Forward returns (y, logdet [B]); reverse returns y."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from mb_istft_vits_torch.nn.blocks import WN, DDSConv
from mb_istft_vits_torch.nn.layers import Conv1d
from mb_istft_vits_torch.nn.transforms import (
    piecewise_rational_quadratic_transform,
)


def flip_channels(x: torch.Tensor) -> torch.Tensor:
    """Flip flow (reference modules.py:280-287); logdet = 0."""
    return torch.flip(x, dims=(1,))


class Flip(nn.Module):
    """Parameter-free Flip, kept as a module so the flows' ModuleList
    indices match the reference state dict."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flip_channels(x)


class Log(nn.Module):
    """y = log(max(x, 1e-5)) forward, exp reverse (reference
    modules.py:269-277)."""

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                reverse: bool = False):
        if not reverse:
            y = torch.log(torch.clamp(x, min=1e-5)) * x_mask
            return y, torch.sum(-y, dim=(1, 2))
        return torch.exp(x) * x_mask


class ElementwiseAffine(nn.Module):
    """Per-channel affine flow (reference modules.py:290-305); m and logs
    are [channels, 1], as in the reference state dict, and start at 0."""

    def __init__(self, channels: int):
        super().__init__()
        self.m = nn.Parameter(torch.zeros(channels, 1))
        self.logs = nn.Parameter(torch.zeros(channels, 1))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                reverse: bool = False):
        if not reverse:
            y = (self.m + torch.exp(self.logs) * x) * x_mask
            return y, torch.sum(self.logs * x_mask, dim=(1, 2))
        return (x - self.m) * torch.exp(-self.logs) * x_mask


class ConvFlow(nn.Module):
    """Spline coupling over the [u, v] channel halves (reference
    modules.py:356-400): the first half, through a DDSConv, parametrises a
    rational-quadratic spline of the second with linear tails beyond
    +-tail_bound. `proj` starts at zero, so the flow is the identity at
    init."""

    def __init__(self, in_channels: int, filter_channels: int,
                 kernel_size: int, n_layers: int, num_bins: int = 10,
                 tail_bound: float = 5.0):
        super().__init__()
        self.half = in_channels // 2
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        self.filter_channels = filter_channels
        self.pre = Conv1d(self.half, filter_channels, 1)
        self.convs = DDSConv(filter_channels, kernel_size, n_layers,
                             p_dropout=0.0)
        self.proj = Conv1d(filter_channels, self.half * (num_bins * 3 - 1), 1)
        nn.init.zeros_(self.proj.weight)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, reverse: bool = False):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.convs(self.pre(x0), x_mask, g)
        h = self.proj(h) * x_mask
        b, c, t = x0.shape
        # [B, half * (3K - 1), T] -> [B, half, T, 3K - 1]: channel j * (3K
        # - 1) + p is parameter p of half-channel j
        h = h.reshape(b, c, -1, t).permute(0, 1, 3, 2)
        k = self.num_bins
        scale = math.sqrt(self.filter_channels)
        x1, logabsdet = piecewise_rational_quadratic_transform(
            x1, h[..., :k] / scale, h[..., k:2 * k] / scale, h[..., 2 * k:],
            inverse=reverse, tails="linear", tail_bound=self.tail_bound)
        x = torch.cat([x0, x1], dim=1) * x_mask
        if reverse:
            return x
        return x, torch.sum(logabsdet * x_mask, dim=(1, 2))


class ResidualCouplingLayer(nn.Module):
    """Affine coupling with a WN body (reference modules.py:308-353).
    The post conv starts at zero, so the coupling is the identity at init."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, p_dropout: float = 0.0,
                 gin_channels: int = 0, mean_only: bool = False):
        super().__init__()
        self.half = channels // 2
        self.mean_only = mean_only
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels, p_dropout=p_dropout)
        self.post = Conv1d(hidden_channels,
                           self.half * (2 - int(mean_only)), 1)
        nn.init.zeros_(self.post.weight)
        nn.init.zeros_(self.post.bias)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None, reverse: bool = False):
        """forward -> (x, logdet [B]); reverse -> x."""
        x0, x1 = x[:, :self.half], x[:, self.half:]
        h = self.enc(self.pre(x0) * x_mask, x_mask, g)
        stats = self.post(h) * x_mask
        if self.mean_only:
            m, logs = stats, torch.zeros_like(stats)
        else:
            m, logs = stats[:, :self.half], stats[:, self.half:]
        if not reverse:
            x1 = (m + x1 * torch.exp(logs)) * x_mask
            return torch.cat([x0, x1], dim=1), torch.sum(logs, dim=(1, 2))
        x1 = (x1 - m) * torch.exp(-logs) * x_mask
        return torch.cat([x0, x1], dim=1)
