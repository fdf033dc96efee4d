"""Composite conv blocks: the dilated depth-separable stack (DDSConv),
gated WaveNet (WN) and HiFi-GAN ResBlocks (counterpart of
`mb_istft_vits_tpu/nn/blocks.py`; reference `modules.py:70-262`). All on
[B, C, T] with masks [B, 1, T].

Global (speaker) conditioning g is [B, gin, 1]. WN adds it through one
weight-normed `cond_layer` that serves every layer; each ResBlock adds it
through a plain 1x1 `cond` conv before its first dilation (JAX
`nn/blocks.py:115-131, 164-165, 209-210`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mb_istft_vits_torch.nn.layers import (
    Conv1d,
    LayerNorm,
    get_padding,
    leaky_relu,
)


class DDSConv(nn.Module):
    """Dilated depth-separable conv stack of the stochastic duration
    predictor (reference modules.py:70-108): per layer a depthwise conv
    (dilation kernel_size ** i), LayerNorm, exact GELU, a 1x1 conv,
    LayerNorm, GELU, dropout, added back to x. g [B, C, T] (a conditioning
    signal of x's shape) is added to the input first."""

    def __init__(self, channels: int, kernel_size: int, n_layers: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.convs_sep = nn.ModuleList()
        self.convs_1x1 = nn.ModuleList()
        self.norms_1 = nn.ModuleList()
        self.norms_2 = nn.ModuleList()
        for i in range(n_layers):
            dilation = kernel_size ** i
            self.convs_sep.append(Conv1d(
                channels, channels, kernel_size, dilation=dilation,
                groups=channels, padding=get_padding(kernel_size, dilation)))
            self.convs_1x1.append(Conv1d(channels, channels, 1))
            self.norms_1.append(LayerNorm(channels))
            self.norms_2.append(LayerNorm(channels))
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        if g is not None:
            x = x + g
        for sep, norm_1, conv_1x1, norm_2 in zip(
                self.convs_sep, self.norms_1, self.convs_1x1, self.norms_2):
            y = F.gelu(norm_1(sep(x * x_mask)))
            y = self.drop(F.gelu(norm_2(conv_1x1(y))))
            x = x + y
        return x * x_mask


class WN(nn.Module):
    """Non-causal WaveNet with gated tanh*sigmoid units; all convs
    weight-normed (reference modules.py:111-176)."""

    def __init__(self, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 p_dropout: float = 0.0):
        super().__init__()
        h = hidden_channels
        self.hidden_channels = h
        if gin_channels:
            # one conv for every layer's conditioning: layer i takes
            # channels [i * 2h, (i + 1) * 2h)
            self.cond_layer = Conv1d(gin_channels, 2 * h * n_layers, 1,
                                     weight_norm=True)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            dilation = dilation_rate**i
            self.in_layers.append(Conv1d(
                h, 2 * h, kernel_size, dilation=dilation,
                padding=get_padding(kernel_size, dilation), weight_norm=True))
            res_skip_ch = 2 * h if i < n_layers - 1 else h
            self.res_skip_layers.append(
                Conv1d(h, res_skip_ch, 1, weight_norm=True))
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.hidden_channels
        output = torch.zeros_like(x)
        g_all = self.cond_layer(g) if g is not None else None
        last = len(self.in_layers) - 1
        for i, (conv_in, conv_rs) in enumerate(
                zip(self.in_layers, self.res_skip_layers)):
            x_in = conv_in(x)
            if g_all is not None:
                x_in = x_in + g_all[:, i * 2 * h:(i + 1) * 2 * h]
            acts = self.drop(torch.tanh(x_in[:, :h]) * torch.sigmoid(x_in[:, h:]))
            res_skip = conv_rs(acts)
            if i < last:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * x_mask


class _ResBlock(nn.Module):
    """The speaker conditioning of both ResBlock types: a plain 1x1 conv
    with a bias, added to the input when g is given."""

    def __init__(self, channels: int, gin_channels: int):
        super().__init__()
        self.cond = Conv1d(gin_channels, channels, 1) if gin_channels \
            else None

    def _condition(self, x: torch.Tensor,
                   g: Optional[torch.Tensor]) -> torch.Tensor:
        return x if g is None or self.cond is None else x + self.cond(g)


class ResBlock1(_ResBlock):
    """HiFi-GAN ResBlock type 1 (reference modules.py:187-228)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5), gin_channels: int = 0):
        super().__init__(channels, gin_channels)
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=get_padding(kernel_size, d), weight_norm=True)
            for d in dilation)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size,
                   padding=get_padding(kernel_size, 1), weight_norm=True)
            for _ in dilation)

    def forward(self, x: torch.Tensor,
                x_mask: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._condition(x, g)
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = leaky_relu(x)
            if x_mask is not None:
                xt = xt * x_mask
            xt = leaky_relu(c1(xt))
            if x_mask is not None:
                xt = xt * x_mask
            x = c2(xt) + x
        if x_mask is not None:
            x = x * x_mask
        return x


class ResBlock2(_ResBlock):
    """HiFi-GAN ResBlock type 2 (reference modules.py:237-262)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3), gin_channels: int = 0):
        super().__init__(channels, gin_channels)
        self.convs = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=get_padding(kernel_size, d), weight_norm=True)
            for d in dilation)

    def forward(self, x: torch.Tensor,
                x_mask: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._condition(x, g)
        for c in self.convs:
            xt = leaky_relu(x)
            if x_mask is not None:
                xt = xt * x_mask
            x = c(xt) + x
        if x_mask is not None:
            x = x * x_mask
        return x
