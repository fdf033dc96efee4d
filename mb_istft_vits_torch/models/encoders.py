"""Text encoder and posterior encoder (counterpart of
`mb_istft_vits_tpu/models/encoders.py`; reference `models.py:140-181,
217-246`). Activations [B, C, T], masks [B, 1, T]."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from mb_istft_vits_torch.nn import WN, Conv1d, TransformerEncoder
from mb_istft_vits_torch.ops import sequence_mask


class TextEncoder(nn.Module):
    """Embedding * sqrt(h) -> rel-pos transformer -> (m, logs) prior
    projection (reference models.py:140-181)."""

    def __init__(self, n_vocab: int, out_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, p_dropout: float):
        super().__init__()
        self.out_channels = out_channels
        self.hidden_channels = hidden_channels
        self.emb = nn.Embedding(n_vocab, hidden_channels)
        nn.init.normal_(self.emb.weight, 0.0, hidden_channels**-0.5)
        self.encoder = TransformerEncoder(hidden_channels, filter_channels,
                                          n_heads, n_layers, kernel_size,
                                          p_dropout)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor):
        """x [B, T] token ids -> (h [B, H, T], m, logs [B, C, T],
        x_mask [B, 1, T])."""
        h = self.emb(x) * math.sqrt(self.hidden_channels)  # [B, T, H]
        h = h.transpose(1, 2)
        x_mask = sequence_mask(x_lengths, x.shape[1]).unsqueeze(1).to(h.dtype)
        h = self.encoder(h * x_mask, x_mask)
        stats = self.proj(h) * x_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        return h, m, logs, x_mask


class PosteriorEncoder(nn.Module):
    """Linear spectrogram -> WN -> reparameterized gaussian posterior
    (reference models.py:217-246)."""

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.out_channels = out_channels
        self.pre = Conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, y: torch.Tensor, y_lengths: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """y [B, spec, T], g [B, gin, 1] or None -> (z, m, logs [B, C, T],
        y_mask [B, 1, T]). `eps` is the posterior noise [B, C, T]; drawn
        from `generator` when not given."""
        y_mask = sequence_mask(y_lengths, y.shape[2]).unsqueeze(1).to(y.dtype)
        h = self.enc(self.pre(y) * y_mask, y_mask, g)
        stats = self.proj(h) * y_mask
        m, logs = torch.split(stats, self.out_channels, dim=1)
        if eps is None:
            eps = torch.randn(m.shape, generator=generator, dtype=m.dtype,
                              device=m.device)
        z = (m + eps * torch.exp(logs)) * y_mask
        return z, m, logs, y_mask
