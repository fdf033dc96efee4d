"""Deterministic duration predictor (counterpart of
`mb_istft_vits_tpu/models/duration.py:DurationPredictor`; reference
`models.py:103-137`). The stochastic predictor is a later slice."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from mb_istft_vits_torch.nn import Conv1d, LayerNorm


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
