"""Multi-band iSTFT waveform decoder (counterpart of
`mb_istft_vits_tpu/models/decoders.py`; reference `models.py:309-384`).

Trunk: conv_pre -> [ConvTranspose upsample -> mean of N ResBlocks] x L ->
leaky_relu -> ReflectionPad(1, 0) -> subband_conv_post; then an
exp / pi*sin spec-phase head, one iSTFT per band and PQMF synthesis.
The single-band iSTFT and the multi-stream heads are a later slice.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mb_istft_vits_torch.dsp.pqmf import PQMF
from mb_istft_vits_torch.dsp.stft import istft
from mb_istft_vits_torch.nn import Conv1d, ConvTranspose1d, ResBlock1, ResBlock2
from mb_istft_vits_torch.nn.layers import leaky_relu


def _spec_phase(x: torch.Tensor, n_fft: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """exp-magnitude / pi*sin-phase head (reference models.py:294-295) on
    [B, s, n_fft + 2, T] -> two [B, s, n_bins, T]."""
    n_bins = n_fft // 2 + 1
    mag, ph = torch.split(x, [n_bins, n_fft + 2 - n_bins], dim=2)
    return torch.exp(mag), math.pi * torch.sin(ph)


def _reflection_pad_left1(x: torch.Tensor) -> torch.Tensor:
    """torch ReflectionPad1d((1, 0)) on time (reference models.py:276)."""
    return F.pad(x, (1, 0), mode="reflect")


class _UpsamplerTrunk(nn.Module):
    """conv_pre + upsample/resblock stack shared by the decoder heads
    (reference models.py:278-291). Its parameters sit directly on the
    decoder (`dec.conv_pre`, `dec.ups.*`, `dec.resblocks.*`), as in the
    reference state dict."""

    def __init__(self, initial_channel: int, resblock: str,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int]):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        res_cls = ResBlock1 if resblock == "1" else ResBlock2
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7,
                               padding=3, weight_norm=True)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(
                ch * 2, ch, k, stride=u, padding=(k - u) // 2,
                weight_norm=True))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(res_cls(ch, rk, tuple(rd)))
        self.out_channels = ch

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(x)
        n = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x))
            xs = None
            for block in self.resblocks[i * n:(i + 1) * n]:
                y = block(x)
                xs = y if xs is None else xs + y
            x = xs / n
        return leaky_relu(x, 0.01)  # F.leaky_relu default slope (models.py:291)


class MultibandISTFTGenerator(_UpsamplerTrunk):
    """Per-band iSTFT + fixed PQMF synthesis (reference models.py:309-384)."""

    def __init__(self, initial_channel: int, resblock: str,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gen_istft_n_fft: int,
                 gen_istft_hop_size: int, subbands: int = 4):
        super().__init__(initial_channel, resblock, resblock_kernel_sizes,
                         resblock_dilation_sizes, upsample_rates,
                         upsample_initial_channel, upsample_kernel_sizes)
        self.n_fft, self.hop, self.subbands = (gen_istft_n_fft,
                                               gen_istft_hop_size, subbands)
        self.subband_conv_post = Conv1d(
            self.out_channels, subbands * (gen_istft_n_fft + 2), 7, padding=3,
            weight_norm=True)
        self.pqmf = PQMF(subbands)

    def bands_from_spec(self, spec: torch.Tensor,
                        phase: torch.Tensor) -> torch.Tensor:
        """Per-band iSTFT: (spec, phase) [B, s, bins, F] -> band-major
        sub-band waveforms [B, s, T_band]."""
        b, s, bins, f = spec.shape
        y = istft(spec.reshape(b * s, bins, f), phase.reshape(b * s, bins, f),
                  self.n_fft, self.hop, self.n_fft)
        return y.view(b, s, -1)

    def forward(self, x: torch.Tensor):
        """x [B, C, T] -> (o [B, 1, T_wav], o_mb [B, s, T_band],
        spec [B, s, bins, T'], phase [B, s, bins, T'])."""
        x = self.subband_conv_post(_reflection_pad_left1(self.trunk(x)))
        b, _, t = x.shape
        spec, phase = _spec_phase(x.view(b, self.subbands, self.n_fft + 2, t),
                                  self.n_fft)
        y_mb = self.bands_from_spec(spec, phase)
        return self.pqmf.synthesis_bm(y_mb), y_mb, spec, phase

    def spec_tail(self, spec: torch.Tensor,
                  phase: torch.Tensor) -> torch.Tensor:
        """The back half of `forward`: (spec, phase) [B, s, bins, F] ->
        full-band waveform [B, 1, T_wav] (the serving spectrogram-domain
        join)."""
        return self.pqmf.synthesis_bm(self.bands_from_spec(spec, phase))
