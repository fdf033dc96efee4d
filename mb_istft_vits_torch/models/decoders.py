"""Waveform decoders: the iSTFT, multi-band iSTFT and multi-stream iSTFT
heads (counterpart of `mb_istft_vits_tpu/models/decoders.py`; reference
`models.py:248-475`), and VITS's own HiFi-GAN generator (VITS
`models.py:Generator`), which the JAX package does not have.

Trunk: conv_pre -> [ConvTranspose upsample -> mean of N ResBlocks] x L ->
leaky_relu. The iSTFT heads go on with ReflectionPad(1, 0) -> post conv,
then an exp / pi*sin spec-phase head and an iSTFT: one full-band iSTFT
(`ISTFTGenerator`), or one per band followed by PQMF synthesis
(`MultibandISTFTGenerator`) or by zero-stuffing and a learned 63-tap
synthesis conv (`MultistreamISTFTGenerator`); their speaker conditioning
g [B, gin, 1] reaches every ResBlock of the trunk. The HiFi-GAN head
(`HiFiGANGenerator`) goes on with a 7-tap conv to one channel and tanh:
its conv_pre has no weight norm, its conv_post neither weight norm nor
bias, and g enters once, through a 1x1 `cond` conv added after conv_pre.

Precision: the spec-phase head and everything after it (the iSTFT, PQMF
synthesis, the multi-stream synthesis conv) run in float32 whatever the
trunk's dtype: cuFFT, and so `torch.istft`, has no bfloat16. A bf16
serving module keeps the parameters and buffers named by a head's
`FLOAT32_TAIL` in float32 (`infer.synthesis.SynthesisModule`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mb_istft_vits_torch.dsp.pqmf import PQMF
from mb_istft_vits_torch.dsp.stft import istft
from mb_istft_vits_torch.nn import Conv1d, ConvTranspose1d, ResBlock1, ResBlock2
from mb_istft_vits_torch.nn.layers import get_padding, leaky_relu


def _spec_phase(x: torch.Tensor, n_fft: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """exp-magnitude / pi*sin-phase head (reference models.py:294-295) on
    [..., n_fft + 2, T] -> two [..., n_bins, T], in float32."""
    n_bins = n_fft // 2 + 1
    mag, ph = torch.split(x.float(), [n_bins, n_fft + 2 - n_bins], dim=-2)
    return torch.exp(mag), math.pi * torch.sin(ph)


def _reflection_pad_left1(x: torch.Tensor) -> torch.Tensor:
    """torch ReflectionPad1d((1, 0)) on time (reference models.py:276)."""
    return F.pad(x, (1, 0), mode="reflect")


class _UpsamplerTrunk(nn.Module):
    """conv_pre + upsample/resblock stack shared by the decoder heads
    (reference models.py:278-291). Its parameters sit directly on the
    decoder (`dec.conv_pre`, `dec.ups.*`, `dec.resblocks.*`), as in the
    reference state dict."""

    # parameters and buffers (names under `dec.`) that stay float32 when
    # the rest of the model is cast to a lower compute dtype
    FLOAT32_TAIL: Tuple[str, ...] = ()

    def __init__(self, initial_channel: int, resblock: str,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gin_channels: int = 0,
                 weight_norm_pre: bool = True):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        res_cls = ResBlock1 if resblock == "1" else ResBlock2
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7,
                               padding=3, weight_norm=weight_norm_pre)
        # the HiFi-GAN head's speaker conv after conv_pre (the iSTFT heads
        # condition each ResBlock instead)
        self.cond: Optional[nn.Module] = None
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(
                ch * 2, ch, k, stride=u, padding=(k - u) // 2,
                weight_norm=True))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(res_cls(ch, rk, tuple(rd),
                                              gin_channels=gin_channels))
        self.out_channels = ch

    def upsample(self, x: torch.Tensor,
                 g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """conv_pre (and `cond`), the upsample / ResBlock stack, then the
        final leaky_relu: [B, C, T] -> [B, ch, T * prod(upsample_rates)]."""
        x = self.conv_pre(x)
        if g is not None and self.cond is not None:
            x = x + self.cond(g)
        n = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x))
            xs = None
            for block in self.resblocks[i * n:(i + 1) * n]:
                y = block(x, g=g)
                xs = y if xs is None else xs + y
            x = xs / n
        # F.leaky_relu's default slope (models.py:291)
        return leaky_relu(x, 0.01)

    def trunk(self, x: torch.Tensor,
              g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The iSTFT heads' trunk, through the left reflection pad:
        [B, C, T] -> [B, ch, T * prod(upsample_rates) + 1]."""
        return _reflection_pad_left1(self.upsample(x, g))


class HiFiGANGenerator(_UpsamplerTrunk):
    """VITS's decoder (VITS `models.py:Generator`): the trunk with a plain
    conv_pre, the speaker added once after it through a 1x1 `cond` conv
    (the ResBlocks take no speaker), then leaky_relu, a 7-tap conv to one
    channel with no bias and no weight norm, and tanh. No spectrogram:
    `forward`'s sub-band, spec and phase outputs are None."""

    def __init__(self, initial_channel: int, resblock: str,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gin_channels: int = 0):
        super().__init__(initial_channel, resblock, resblock_kernel_sizes,
                         resblock_dilation_sizes, upsample_rates,
                         upsample_initial_channel, upsample_kernel_sizes,
                         weight_norm_pre=False)
        self.conv_post = Conv1d(self.out_channels, 1, 7, padding=3,
                                bias=False)
        if gin_channels:
            self.cond = Conv1d(gin_channels, upsample_initial_channel, 1)

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None):
        """x [B, C, T] -> (o [B, 1, T * prod(upsample_rates)], None, None,
        None)."""
        return torch.tanh(self.conv_post(self.upsample(x, g))), None, None, \
            None

    def spec_tail(self, spec, phase):
        raise ValueError("the HiFi-GAN head decodes to a waveform directly: "
                         "it has no spectrogram to join")


class ISTFTGenerator(_UpsamplerTrunk):
    """One full-band iSTFT (reference models.py:248-306)."""

    def __init__(self, initial_channel: int, resblock: str,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gen_istft_n_fft: int,
                 gen_istft_hop_size: int, gin_channels: int = 0):
        super().__init__(initial_channel, resblock, resblock_kernel_sizes,
                         resblock_dilation_sizes, upsample_rates,
                         upsample_initial_channel, upsample_kernel_sizes,
                         gin_channels)
        self.n_fft, self.hop = gen_istft_n_fft, gen_istft_hop_size
        self.conv_post = Conv1d(self.out_channels, gen_istft_n_fft + 2, 7,
                                padding=3, weight_norm=True)

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None):
        """x [B, C, T] -> (o [B, 1, T_wav], None, spec [B, bins, T'],
        phase [B, bins, T'])."""
        spec, phase = _spec_phase(self.conv_post(self.trunk(x, g)),
                                  self.n_fft)
        return self.spec_tail(spec, phase), None, spec, phase

    def spec_tail(self, spec: torch.Tensor,
                  phase: torch.Tensor) -> torch.Tensor:
        """(spec, phase) [B, bins, F] -> waveform [B, 1, T_wav]: the back
        half of `forward` (the serving spectrogram-domain join)."""
        return istft(spec, phase, self.n_fft, self.hop, self.n_fft)[:, None]


class _SubbandISTFTGenerator(_UpsamplerTrunk):
    """Trunk + per-band iSTFT shared by the MB and MS heads (reference
    models.py:344-373, 430-461)."""

    def __init__(self, initial_channel: int, resblock: str,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gen_istft_n_fft: int,
                 gen_istft_hop_size: int, subbands: int = 4,
                 gin_channels: int = 0):
        super().__init__(initial_channel, resblock, resblock_kernel_sizes,
                         resblock_dilation_sizes, upsample_rates,
                         upsample_initial_channel, upsample_kernel_sizes,
                         gin_channels)
        self.n_fft, self.hop, self.subbands = (gen_istft_n_fft,
                                               gen_istft_hop_size, subbands)
        self.subband_conv_post = Conv1d(
            self.out_channels, subbands * (gen_istft_n_fft + 2), 7, padding=3,
            weight_norm=True)

    def bands_from_spec(self, spec: torch.Tensor,
                        phase: torch.Tensor) -> torch.Tensor:
        """Per-band iSTFT: (spec, phase) [B, s, bins, F] -> band-major
        sub-band waveforms [B, s, T_band]."""
        b, s, bins, f = spec.shape
        y = istft(spec.reshape(b * s, bins, f), phase.reshape(b * s, bins, f),
                  self.n_fft, self.hop, self.n_fft)
        return y.view(b, s, -1)

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None):
        """x [B, C, T] -> (o [B, 1, T_wav], o_mb, spec [B, s, bins, T'],
        phase [B, s, bins, T']); o_mb is the head's `_synthesis` input."""
        x = self.subband_conv_post(self.trunk(x, g))
        b, _, t = x.shape
        spec, phase = _spec_phase(x.view(b, self.subbands, self.n_fft + 2, t),
                                  self.n_fft)
        o, o_mb = self._synthesis(self.bands_from_spec(spec, phase))
        return o, o_mb, spec, phase

    def spec_tail(self, spec: torch.Tensor,
                  phase: torch.Tensor) -> torch.Tensor:
        """The back half of `forward`: (spec, phase) [B, s, bins, F] ->
        full-band waveform [B, 1, T_wav] (the serving spectrogram-domain
        join)."""
        return self._synthesis(self.bands_from_spec(spec, phase))[0]


class MultibandISTFTGenerator(_SubbandISTFTGenerator):
    """Per-band iSTFT + fixed PQMF synthesis (reference models.py:309-384).
    o_mb is the band-major sub-band waveforms [B, s, T_band]."""

    FLOAT32_TAIL = ("pqmf.",)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.pqmf = PQMF(self.subbands)

    def _synthesis(self, y_mb: torch.Tensor):
        return self.pqmf.synthesis_bm(y_mb), y_mb


class MultistreamISTFTGenerator(_SubbandISTFTGenerator):
    """Per-band iSTFT + trainable synthesis filters (reference
    models.py:387-474): zero-stuffing x s (the identity `updown_filter`,
    models.py:463) then a learned 63-tap conv, s -> 1 channels, no bias.
    o_mb is the zero-stuffed conv input [B, s, T_band * s] (JAX returns
    it channels-last, [B, T_band * s, s])."""

    FLOAT32_TAIL = ("multistream_conv_post.",)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.multistream_conv_post = Conv1d(
            self.subbands, 1, 63, padding=get_padding(63, 1), bias=False,
            weight_norm=True)

    def _synthesis(self, y_mb: torch.Tensor):
        # band c's sample t at offset 0 of block t, scaled by s (JAX
        # `_zero_stuff`, decoders.py:232-240)
        b, s, t = y_mb.shape
        up = F.pad((y_mb * s)[..., None], (0, s - 1)).reshape(b, s, t * s)
        return self.multistream_conv_post(up), up
