"""Relative-position multi-head attention encoder (counterpart of
`mb_istft_vits_tpu/nn/attention.py`; reference `attentions.py:13-47,
101-254,257-303`). Activations [B, C, T]."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from mb_istft_vits_torch.nn.layers import Conv1d, LayerNorm


def _rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """[b, h, l, 2l-1] -> [b, h, l, l] (reference attentions.py:214-229)."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, l * 2 * l)
    x = F.pad(x, (0, l - 1)).reshape(b, h, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1:]


def _abs_to_rel(x: torch.Tensor) -> torch.Tensor:
    """[b, h, l, l] -> [b, h, l, 2l-1] (reference attentions.py:231-243)."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1)).reshape(b, h, l * l + l * (l - 1))
    x = F.pad(x, (l, 0)).reshape(b, h, l, 2 * l)
    return x[:, :, :, 1:]


def _get_relative_embeddings(emb: torch.Tensor, length: int,
                             window_size: int) -> torch.Tensor:
    """Slice/pad the +-window table [1, 2w+1, d_k] to 2*length-1 entries
    (reference attentions.py:199-212)."""
    pad_len = max(length - (window_size + 1), 0)
    start = max((window_size + 1) - length, 0)
    if pad_len > 0:
        emb = F.pad(emb, (0, 0, pad_len, pad_len))
    return emb[:, start:start + 2 * length - 1]


class MultiHeadAttention(nn.Module):
    """Self-attention with learned relative positions shared by all heads
    (reference attentions.py:101-254, the encoder's configuration)."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 p_dropout: float = 0.0, window_size: int = 4):
        super().__init__()
        self.n_heads = n_heads
        self.window_size = window_size
        self.k_channels = channels // n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)
        for conv in (self.conv_q, self.conv_k, self.conv_v):
            nn.init.xavier_uniform_(conv.weight)
        rel_std = self.k_channels**-0.5
        n_rel = 2 * window_size + 1
        self.emb_rel_k = nn.Parameter(
            torch.randn(1, n_rel, self.k_channels) * rel_std)
        self.emb_rel_v = nn.Parameter(
            torch.randn(1, n_rel, self.k_channels) * rel_std)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor) -> torch.Tensor:
        """x [B, C, T], attn_mask [B, 1, T, T] -> [B, out_channels, T]."""
        b, c, t = x.shape
        h, d_k = self.n_heads, self.k_channels

        def split(z):  # [B, C, T] -> [B, h, T, d_k]
            return z.view(b, h, d_k, t).transpose(2, 3)

        q = split(self.conv_q(x)) * (1.0 / math.sqrt(d_k))
        k = split(self.conv_k(x))
        v = split(self.conv_v(x))
        scores = torch.matmul(q, k.transpose(-2, -1))
        key_rel = _get_relative_embeddings(self.emb_rel_k, t, self.window_size)
        scores = scores + _rel_to_abs(torch.matmul(q, key_rel[0].t()))
        scores = scores.masked_fill(attn_mask == 0, -1e4)
        p = self.drop(torch.softmax(scores, dim=-1))
        out = torch.matmul(p, v)
        val_rel = _get_relative_embeddings(self.emb_rel_v, t, self.window_size)
        out = out + torch.matmul(_abs_to_rel(p), val_rel[0])
        out = out.transpose(2, 3).reshape(b, c, t)
        return self.conv_o(out)


class FFN(nn.Module):
    """Conv feed-forward with 'same' padding (reference attentions.py:257-303)."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size)
        self.drop = nn.Dropout(p_dropout)

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        if k == 1:
            return x
        return F.pad(x, ((k - 1) // 2, k // 2))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        y = self.conv_1(self._pad(x * x_mask))
        y = self.drop(torch.relu(y))
        y = self.conv_2(self._pad(y * x_mask))
        return y * x_mask


class TransformerEncoder(nn.Module):
    """Rel-pos transformer encoder with post-LayerNorm
    (reference attentions.py:13-47)."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 p_dropout: float = 0.0, window_size: int = 4):
        super().__init__()
        hc = hidden_channels
        self.drop = nn.Dropout(p_dropout)
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(hc, hc, n_heads, p_dropout, window_size)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(LayerNorm(hc)
                                           for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(hc, hc, filter_channels, kernel_size, p_dropout)
            for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(LayerNorm(hc)
                                           for _ in range(n_layers))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        """x [B, C, T], x_mask [B, 1, T]."""
        attn_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)  # [B,1,T,T]
        x = x * x_mask
        for attn, norm1, ffn, norm2 in zip(self.attn_layers,
                                           self.norm_layers_1,
                                           self.ffn_layers,
                                           self.norm_layers_2):
            x = norm1(x + self.drop(attn(x, attn_mask)))
            x = norm2(x + self.drop(ffn(x, x_mask)))
        return x * x_mask
