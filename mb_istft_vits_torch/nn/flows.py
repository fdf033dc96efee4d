"""Normalizing-flow layers of the prior flow: Flip and the affine residual
coupling (counterpart of `mb_istft_vits_tpu/nn/flows.py`; reference
`modules.py:280-353`). Flip reverses the channel axis of [B, C, T];
the speaker conditioning g is [B, gin, 1]."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from mb_istft_vits_torch.nn.blocks import WN
from mb_istft_vits_torch.nn.layers import Conv1d


def flip_channels(x: torch.Tensor) -> torch.Tensor:
    """Flip flow (reference modules.py:280-287); logdet = 0."""
    return torch.flip(x, dims=(1,))


class Flip(nn.Module):
    """Parameter-free Flip, kept as a module so the flow's ModuleList
    indices match the reference state dict (couplings at even indices)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flip_channels(x)


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
