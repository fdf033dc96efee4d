"""Core layers: 1-D and 2-D convs with optional weight norm, transposed
convs, channel LayerNorm (counterpart of `mb_istft_vits_tpu/nn/layers.py`).

Layout: activations [B, C, T] ([B, C, H, W] for the 2-D convs). Parameter
names and shapes are those of the reference torch modules, so reference
`G_*.pth` / `D_*.pth` state dicts load as they are: weight norm is stored
as (`weight_g`, `weight_v`).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1  # reference modules.py:17


def leaky_relu(x: torch.Tensor, slope: float = LRELU_SLOPE) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def scale(x: torch.Tensor, k) -> torch.Tensor:
    """x times a knob k, a Python float or a 0-dim float32 tensor (the
    serving programs take their knobs as tensors on the device), computed
    in float32 and rounded to x's dtype. That is what a Python float does
    to a bf16 or f16 x; a 0-dim tensor on the card would be rounded to x's
    dtype before the product, so `x * k` alone gives other bits there."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return (x.float() * k).to(x.dtype)
    return x * k


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    """reference commons.py:14-15"""
    return (kernel_size * dilation - dilation) // 2


def _weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """w = g * v / ||v||, the norm over every dim but 0 (torch weight_norm
    with dim=0); the 1e-12 matches the JAX layers."""
    dims = tuple(range(1, v.dim()))
    return v * (g / torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True)
                               + 1e-12))


class _WeightNormMixin:
    """`weight` as a plain parameter, or derived from (weight_g, weight_v)."""

    def _init_weight(self, w: torch.Tensor, weight_norm: bool) -> None:
        if weight_norm:
            dims = tuple(range(1, w.dim()))
            self.weight_v = nn.Parameter(w)
            self.weight_g = nn.Parameter(
                torch.sqrt(torch.sum(w * w, dim=dims, keepdim=True)))
        else:
            self.weight = nn.Parameter(w)
        self.weight_norm = weight_norm

    def _weight(self) -> torch.Tensor:
        if self.weight_norm:
            return _weight_norm(self.weight_v, self.weight_g)
        return self.weight


class Conv1d(_WeightNormMixin, nn.Module):
    """torch.nn.Conv1d with optional weight norm; default init as torch's."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = True,
                 weight_norm: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        w = torch.empty(out_channels, in_channels // groups, kernel_size)
        nn.init.kaiming_uniform_(w, a=math.sqrt(5))
        self._init_weight(w, weight_norm)
        if bias:
            bound = 1.0 / math.sqrt((in_channels // groups) * kernel_size)
            self.bias = nn.Parameter(torch.empty(out_channels)
                                     .uniform_(-bound, bound))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self._weight(), self.bias, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose1d(_WeightNormMixin, nn.Module):
    """torch.nn.ConvTranspose1d with optional weight norm. The weight is
    [in, out, k], so weight norm's g runs over the INPUT channels."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 weight_norm: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        w = torch.empty(in_channels, out_channels, kernel_size)
        nn.init.kaiming_uniform_(w, a=math.sqrt(5))
        self._init_weight(w, weight_norm)
        if bias:
            bound = 1.0 / math.sqrt(out_channels * kernel_size)
            self.bias = nn.Parameter(torch.empty(out_channels)
                                     .uniform_(-bound, bound))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self._weight(), self.bias, self.stride,
                                  self.padding)


class Conv2d(_WeightNormMixin, nn.Module):
    """torch.nn.Conv2d with optional weight norm (the period
    discriminators' convs, JAX `Conv2dP`); default init as torch's. The
    weight is [out, in, kh, kw], so g runs over the output channels."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int] = (0, 0), bias: bool = True,
                 weight_norm: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        w = torch.empty(out_channels, in_channels, *kernel_size)
        nn.init.kaiming_uniform_(w, a=math.sqrt(5))
        self._init_weight(w, weight_norm)
        if bias:
            bound = 1.0 / math.sqrt(in_channels * kernel_size[0]
                                    * kernel_size[1])
            self.bias = nn.Parameter(torch.empty(out_channels)
                                     .uniform_(-bound, bound))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self._weight(), self.bias, self.stride,
                        self.padding)


class LayerNorm(nn.Module):
    """LayerNorm over the channel axis of [B, C, T], computed in float32
    (reference modules.py:20-32)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=1, keepdim=True)
        var = (x32 - mean).square().mean(dim=1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.gamma[None, :, None] + self.beta[None, :, None]
        return y.to(x.dtype)
