"""Multi-head attention with relative positions, the conv FFN, and the
transformer encoder and decoder (counterpart of
`mb_istft_vits_tpu/nn/attention.py`; reference `attentions.py:13-303`).
Activations [B, C, T]. The shipped configs run the encoder only."""

from __future__ import annotations

import math
from typing import Optional

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
    """Slice/pad the +-window table [heads_rel, 2w+1, d_k] to 2*length-1
    entries (reference attentions.py:199-212)."""
    pad_len = max(length - (window_size + 1), 0)
    start = max((window_size + 1) - length, 0)
    if pad_len > 0:
        emb = F.pad(emb, (0, 0, pad_len, pad_len))
    return emb[:, start:start + 2 * length - 1]


def attention_bias_proximal(length: int) -> torch.Tensor:
    """[1, 1, t, t] bias favouring nearby positions, -log1p(|i - j|)
    (reference attentions.py:245-254)."""
    r = torch.arange(length, dtype=torch.float32)
    return -torch.log1p(torch.abs(r[None, :] - r[:, None]))[None, None]


def subsequent_mask(length: int) -> torch.Tensor:
    """Lower-triangular causal mask [1, 1, t, t] (reference
    commons.py:95-97)."""
    return torch.tril(torch.ones(length, length))[None, None]


class MultiHeadAttention(nn.Module):
    """Multi-head attention (reference attentions.py:101-254): 1x1-conv
    Q/K/V/O, learned relative positions within +-`window_size` (none when
    None), one table for all heads or one a head (`heads_share`).

    Self-attention when `context` is None, cross-attention on it
    otherwise (the reference Decoder's encdec path). The reference's
    extras: `proximal_bias` adds -log1p(|i - j|) to the scores,
    `proximal_init` starts conv_k as a copy of conv_q, and `block_length`
    limits attention to +-block_length around the diagonal when a mask is
    given. The relative tables, the proximal bias and the band need
    queries and keys of one length."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 p_dropout: float = 0.0, window_size: Optional[int] = 4,
                 heads_share: bool = True,
                 block_length: Optional[int] = None,
                 proximal_bias: bool = False, proximal_init: bool = False):
        super().__init__()
        self.n_heads = n_heads
        self.window_size = window_size
        self.block_length = block_length
        self.proximal_bias = proximal_bias
        self.k_channels = channels // n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)
        for conv in (self.conv_q, self.conv_k, self.conv_v):
            nn.init.xavier_uniform_(conv.weight)
        if window_size is not None:
            rel_std = self.k_channels**-0.5
            shape = (1 if heads_share else n_heads, 2 * window_size + 1,
                     self.k_channels)
            self.emb_rel_k = nn.Parameter(torch.randn(shape) * rel_std)
            self.emb_rel_v = nn.Parameter(torch.randn(shape) * rel_std)
        if proximal_init:
            with torch.no_grad():
                self.conv_k.weight.copy_(self.conv_q.weight)
                self.conv_k.bias.copy_(self.conv_q.bias)
        self.drop = nn.Dropout(p_dropout)

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, C, T_q], attn_mask [B or 1, 1, T_q, T_kv] (0 = masked) or
        None, context [B, C, T_kv] or None (self-attention) ->
        [B, out_channels, T_q]."""
        c = x if context is None else context
        b, ch, t = x.shape
        t_s = c.shape[2]
        h, d_k = self.n_heads, self.k_channels
        if t_s != t and (self.window_size is not None or self.proximal_bias
                         or (self.block_length is not None
                             and attn_mask is not None)):
            raise ValueError("relative positions, the proximal bias and "
                             "block_length need queries and keys of one "
                             f"length; got {t} and {t_s}")

        def split(z):  # [B, C, T] -> [B, h, T, d_k]
            return z.view(b, h, d_k, z.shape[2]).transpose(2, 3)

        q = split(self.conv_q(x)) * (1.0 / math.sqrt(d_k))
        k = split(self.conv_k(c))
        v = split(self.conv_v(c))
        scores = torch.matmul(q, k.transpose(-2, -1))
        if self.window_size is not None:
            key_rel = _get_relative_embeddings(self.emb_rel_k, t,
                                               self.window_size)
            # one shared table: a 2-D product; one a head: [h, d_k, m]
            rel = key_rel[0].t() if key_rel.shape[0] == 1 \
                else key_rel.transpose(1, 2)
            scores = scores + _rel_to_abs(torch.matmul(q, rel))
        if self.proximal_bias:
            scores = scores + attention_bias_proximal(t).to(scores)
        if attn_mask is not None:
            scores = scores.masked_fill(attn_mask == 0, -1e4)
            if self.block_length is not None:
                band = torch.ones(t, t, device=scores.device).triu(
                    -self.block_length).tril(self.block_length)
                scores = scores.masked_fill(band == 0, -1e4)
        p = self.drop(torch.softmax(scores, dim=-1))
        out = torch.matmul(p, v)
        if self.window_size is not None:
            val_rel = _get_relative_embeddings(self.emb_rel_v, t,
                                               self.window_size)
            out = out + torch.matmul(
                _abs_to_rel(p),
                val_rel[0] if val_rel.shape[0] == 1 else val_rel)
        out = out.transpose(2, 3).reshape(b, ch, t)
        return self.conv_o(out)


class FFN(nn.Module):
    """Conv feed-forward with 'same' padding, or causal padding (k - 1
    before) when `causal` (reference attentions.py:257-303)."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0, causal: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.causal = causal
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size)
        self.drop = nn.Dropout(p_dropout)

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        if k == 1:
            return x
        if self.causal:
            return F.pad(x, (k - 1, 0))
        return F.pad(x, ((k - 1) // 2, k // 2))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor) -> torch.Tensor:
        y = self.conv_1(self._pad(x * x_mask))
        y = self.drop(torch.relu(y))
        y = self.conv_2(self._pad(y * x_mask))
        return y * x_mask


class TransformerDecoder(nn.Module):
    """Causal transformer decoder (reference attentions.py:50-98
    `Decoder`): per layer, masked self-attention with the proximal bias
    and init, encoder-decoder attention on the memory h, then a causal
    conv FFN, each followed by dropout, a residual add and LayerNorm.
    Unused by the shipped configs; part of the reference's surface."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 p_dropout: float = 0.0, proximal_bias: bool = True,
                 proximal_init: bool = True):
        super().__init__()
        hc = hidden_channels

        def layers(make):
            return nn.ModuleList(make() for _ in range(n_layers))

        self.drop = nn.Dropout(p_dropout)
        self.self_attn_layers = layers(lambda: MultiHeadAttention(
            hc, hc, n_heads, p_dropout, window_size=None,
            proximal_bias=proximal_bias, proximal_init=proximal_init))
        self.norm_layers_0 = layers(lambda: LayerNorm(hc))
        self.encdec_attn_layers = layers(lambda: MultiHeadAttention(
            hc, hc, n_heads, p_dropout, window_size=None))
        self.norm_layers_1 = layers(lambda: LayerNorm(hc))
        self.ffn_layers = layers(lambda: FFN(
            hc, hc, filter_channels, kernel_size, p_dropout, causal=True))
        self.norm_layers_2 = layers(lambda: LayerNorm(hc))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                h: torch.Tensor, h_mask: torch.Tensor) -> torch.Tensor:
        """x [B, C, T_q], x_mask [B, 1, T_q], h [B, C, T_kv] the encoder's
        states, h_mask [B, 1, T_kv] -> [B, C, T_q]."""
        self_attn_mask = subsequent_mask(x.shape[2]).to(x)  # [1,1,T,T]
        encdec_attn_mask = h_mask.unsqueeze(2) * x_mask.unsqueeze(-1)
        x = x * x_mask
        for i in range(len(self.self_attn_layers)):
            y = self.self_attn_layers[i](x, self_attn_mask)
            x = self.norm_layers_0[i](x + self.drop(y))
            y = self.encdec_attn_layers[i](x, encdec_attn_mask, h)
            x = self.norm_layers_1[i](x + self.drop(y))
            y = self.ffn_layers[i](x, x_mask)
            x = self.norm_layers_2[i](x + self.drop(y))
        return x * x_mask


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
