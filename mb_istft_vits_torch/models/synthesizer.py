"""Top-level VITS synthesizer: training forward, inference, latent-only
inference, decoder-only decode (counterpart of
`mb_istft_vits_tpu/models/synthesizer.py`; reference `models.py:568-798`).

Modules run in [B, C, T]; the public methods take and return the JAX
package's channels-last layouts ([B, T, C], waveforms [B, T_wav, 1],
alignments [B, T_y, T_x]), so the two packages compare like with like.

Randomness is explicit: `forward` takes the posterior noise and the slice
starts, `infer` the prior noise `eps`, as tensors; whatever is not given
is drawn from the `generator` passed in.

Not ported yet: the stochastic duration predictor (and with it the
`noise_scale_w` knob of `infer`), multi-speaker conditioning and the
single-band / multi-stream decoder heads.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from mb_istft_vits_torch.config import ModelConfig
from mb_istft_vits_torch.models.decoders import MultibandISTFTGenerator
from mb_istft_vits_torch.models.duration import DurationPredictor
from mb_istft_vits_torch.models.encoders import PosteriorEncoder, TextEncoder
from mb_istft_vits_torch.nn.flows import Flip, ResidualCouplingLayer
from mb_istft_vits_torch.ops import (
    generate_path,
    maximum_path,
    rand_slice_segments,
    sequence_mask,
)


def _cl(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T] <-> [B, T, C]."""
    return x.transpose(1, 2)


class ResidualCouplingBlock(nn.Module):
    """4 x (affine coupling + Flip), invertible (reference models.py:184-214)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate,
                n_layers, mean_only=True))
            self.flows.append(Flip())

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
        if not reverse:
            for flow in self.flows:
                x = flow(x) if isinstance(flow, Flip) else flow(x, x_mask)[0]
        else:
            for flow in reversed(self.flows):
                x = flow(x) if isinstance(flow, Flip) else \
                    flow(x, x_mask, reverse=True)
        return x


def mas_neg_cent(z_p: torch.Tensor, m_p: torch.Tensor,
                 logs_p: torch.Tensor) -> torch.Tensor:
    """Log-likelihood of every (frame, token) pair under the prior, in
    float32 whatever autocast is on (reference models.py:668-676):
    z_p [B, C, T_y], m_p / logs_p [B, C, T_x] -> [B, T_y, T_x]."""
    zp = z_p.detach().float()
    mp = m_p.detach().float()
    lp = logs_p.detach().float()
    with torch.autocast(zp.device.type, enabled=False):
        s_p_sq_r = torch.exp(-2.0 * lp)  # [B, C, T_x]
        nc1 = torch.sum(-0.5 * math.log(2 * math.pi) - lp, dim=1,
                        keepdim=True)
        nc2 = torch.matmul(_cl(-0.5 * zp * zp), s_p_sq_r)
        nc3 = torch.matmul(_cl(zp), mp * s_p_sq_r)
        nc4 = torch.sum(-0.5 * mp * mp * s_p_sq_r, dim=1, keepdim=True)
        return nc1 + nc2 + nc3 + nc4


class InferOutput(NamedTuple):
    o: torch.Tensor          # [B, T_wav, 1]
    o_mb: torch.Tensor       # [B, s, T_band]
    spec: torch.Tensor       # [B, T', s, bins]
    phase: torch.Tensor      # [B, T', s, bins]
    attn: torch.Tensor       # [B, max_frames, T_x]
    y_mask: torch.Tensor     # [B, max_frames, 1]
    y_lengths: torch.Tensor  # [B] frames
    latents: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class Synthesizer(nn.Module):
    """SynthesizerTrn equivalent (reference models.py:568-798) for the
    single-speaker MB-iSTFT model with the deterministic duration
    predictor."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.decoder_kind != "mb_istft":
            raise NotImplementedError(
                f"decoder {cfg.decoder_kind!r} is not ported yet (mb_istft is)")
        if cfg.use_sdp:
            raise NotImplementedError(
                "the stochastic duration predictor is not ported yet")
        if cfg.n_speakers > 1:
            raise NotImplementedError("multi-speaker models are not ported yet")
        self.cfg = cfg
        self.enc_p = TextEncoder(
            cfg.n_vocab, cfg.inter_channels, cfg.hidden_channels,
            cfg.filter_channels, cfg.n_heads, cfg.n_layers, cfg.kernel_size,
            cfg.p_dropout)
        self.dec = MultibandISTFTGenerator(
            cfg.inter_channels, cfg.resblock, cfg.resblock_kernel_sizes,
            cfg.resblock_dilation_sizes, cfg.upsample_rates,
            cfg.upsample_initial_channel, cfg.upsample_kernel_sizes,
            cfg.gen_istft_n_fft, cfg.gen_istft_hop_size, cfg.subbands)
        self.enc_q = PosteriorEncoder(cfg.spec_channels, cfg.inter_channels,
                                      cfg.hidden_channels, 5, 1, 16)
        self.flow = ResidualCouplingBlock(cfg.inter_channels,
                                          cfg.hidden_channels, 5, 1, 4)
        self.dp = DurationPredictor(cfg.hidden_channels, 256, 3, 0.5)

    def _decode(self, z: torch.Tensor):
        """Decoder on [B, C, T]; outputs in the JAX layouts."""
        o, o_mb, spec, phase = self.dec(z)
        return (_cl(o), o_mb, spec.permute(0, 3, 1, 2),
                phase.permute(0, 3, 1, 2))

    # ------------------------------------------------------------------
    # training forward (reference models.py:657-695)
    # ------------------------------------------------------------------
    def forward(
        self,
        x: torch.Tensor,
        x_lengths: torch.Tensor,
        y: torch.Tensor,
        y_lengths: torch.Tensor,
        posterior_eps: Optional[torch.Tensor] = None,
        ids_slice: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        mas_force: str = "auto",
    ):
        """x [B, T_x] ids, y [B, T_y, spec] linear spectrogram,
        posterior_eps [B, T_y, C]. Dropout follows `self.training`.
        mas_force is `ops.mas.maximum_path(force=)`: "auto" takes the
        fused kernel whenever its shared memory fits, which on an H100 is
        every training shape, so "two_pass" is how a run reaches the
        two-pass kernels.

        Returns the JAX package's tuple: (o [B, seg*hop, 1],
        o_mb [B, s, seg*hop/s], l_length [B], attn [B, T_y, T_x],
        ids_slice [B], x_mask [B, T_x, 1], y_mask [B, T_y, 1],
        (z, z_p, m_p, logs_p, m_q, logs_q) each [B, T, C])."""
        cfg = self.cfg
        h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths)
        z, m_q, logs_q, y_mask = self.enc_q(
            _cl(y), y_lengths,
            eps=None if posterior_eps is None else _cl(posterior_eps),
            generator=generator)
        z_p = self.flow(z, y_mask)

        # hard alignment (reference models.py:668-678), no gradient
        with torch.no_grad():
            neg_cent = mas_neg_cent(z_p, m_p, logs_p)
            attn_mask = _cl(y_mask) * x_mask  # [B, T_y, T_x]
            attn32 = maximum_path(neg_cent, attn_mask.float(),
                                  force=mas_force)
        attn = attn32.to(z_p.dtype)

        # duration target and loss in float32 (train_latest.py:190,205)
        w = attn32.sum(dim=1, keepdim=True)  # [B, 1, T_x]
        x_mask32 = x_mask.float()
        logw_ = torch.log(w + 1e-6) * x_mask32
        logw = self.dp(h, x_mask).float()
        l_length = torch.sum((logw - logw_) ** 2, dim=(1, 2)) / torch.sum(
            x_mask32)

        # expand the prior over frames (reference models.py:690-691)
        m_p = torch.matmul(m_p, _cl(attn))
        logs_p = torch.matmul(logs_p, _cl(attn))

        z_slice, ids_slice = rand_slice_segments(
            z, y_lengths, cfg.segment_size, generator=generator,
            ids_str=ids_slice)
        o, o_mb, _, _ = self._decode(z_slice)
        return (o, o_mb, l_length, attn, ids_slice, _cl(x_mask), _cl(y_mask),
                tuple(_cl(t) for t in (z, z_p, m_p, logs_p, m_q, logs_q)))

    def fake_slice(
        self,
        y: torch.Tensor,
        y_lengths: torch.Tensor,
        posterior_eps: Optional[torch.Tensor] = None,
        ids_slice: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """The part of `forward` that makes the discriminator's fake:
        posterior -> random slice -> decoder. Under the same draws its
        output is `forward`'s (o, ids_slice). The trainer runs one full
        forward per step instead, as the reference does; this stays for
        callers that need only the fake."""
        z, _, _, _ = self.enc_q(
            _cl(y), y_lengths,
            eps=None if posterior_eps is None else _cl(posterior_eps),
            generator=generator)
        z_slice, ids_slice = rand_slice_segments(
            z, y_lengths, self.cfg.segment_size, generator=generator,
            ids_str=ids_slice)
        return self._decode(z_slice)[0], ids_slice

    # ------------------------------------------------------------------
    # inference (reference models.py:697-737)
    # ------------------------------------------------------------------
    def _duration_head(self, x, x_lengths, length_scale):
        """Text encoder + duration predictor + ceil: the one definition of
        predicted durations, shared by `predict_frames` and `infer`."""
        h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths)
        logw = self.dp(h, x_mask)
        w_ceil = torch.ceil(torch.exp(logw) * x_mask * length_scale)
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1.0)
        return m_p, logs_p, x_mask, w_ceil, y_lengths.to(torch.int32)

    def _infer_latents(self, x, x_lengths, noise_scale, length_scale,
                       max_frames, eps, generator):
        m_p, logs_p, x_mask, w_ceil, y_lengths = self._duration_head(
            x, x_lengths, length_scale)
        if max_frames is None:
            max_frames = int(y_lengths.max())
        y_lengths = torch.clamp(y_lengths, max=max_frames)
        y_mask = sequence_mask(y_lengths, max_frames).unsqueeze(1).to(
            x_mask.dtype)
        attn = generate_path(w_ceil[:, 0], _cl(y_mask) * x_mask)  # [B,Ty,Tx]
        m_p = torch.matmul(m_p, _cl(attn))
        logs_p = torch.matmul(logs_p, _cl(attn))
        if eps is None:
            eps = torch.randn(m_p.shape, generator=generator, dtype=m_p.dtype,
                              device=m_p.device)
        else:
            eps = _cl(eps)
        z_p = m_p + eps * torch.exp(logs_p) * noise_scale
        z = self.flow(z_p, y_mask, reverse=True)
        return z, z_p, m_p, logs_p, attn, y_mask, y_lengths

    def predict_frames(self, x: torch.Tensor, x_lengths: torch.Tensor,
                       length_scale: float = 1.0) -> torch.Tensor:
        """Total predicted frames per utterance [B] (text encoder +
        duration predictor only)."""
        return self._duration_head(x, x_lengths, length_scale)[-1]

    def infer(
        self,
        x: torch.Tensor,
        x_lengths: torch.Tensor,
        noise_scale: float = 1.0,
        length_scale: float = 1.0,
        max_frames: Optional[int] = 1000,
        eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> InferOutput:
        """Text -> waveform. `max_frames` bounds the output frames as in the
        JAX package; None sizes it to the longest predicted utterance.
        `eps` [B, max_frames, C] is the prior noise."""
        z, z_p, m_p, logs_p, attn, y_mask, y_lengths = self._infer_latents(
            x, x_lengths, noise_scale, length_scale, max_frames, eps,
            generator)
        o, o_mb, spec, phase = self._decode(z * y_mask)
        return InferOutput(o, o_mb, spec, phase, attn, _cl(y_mask), y_lengths,
                           tuple(_cl(t) for t in (z, z_p, m_p, logs_p)))

    def infer_z_only(self, x: torch.Tensor, x_lengths: torch.Tensor,
                     noise_scale: float = 1.0, length_scale: float = 1.0,
                     max_frames: Optional[int] = 1000,
                     eps: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """Latents only: (attn, y_mask, y_lengths, (z, z_p, m_p, logs_p))
        (reference models.py:742-788)."""
        z, z_p, m_p, logs_p, attn, y_mask, y_lengths = self._infer_latents(
            x, x_lengths, noise_scale, length_scale, max_frames, eps,
            generator)
        return (attn, _cl(y_mask), y_lengths,
                tuple(_cl(t) for t in (z, z_p, m_p, logs_p)))

    def decode(self, z: torch.Tensor, sid: Optional[torch.Tensor] = None,
               y_mask: Optional[torch.Tensor] = None):
        """Decoder only: z [B, T, C] (y_mask [B, T, 1]) ->
        (o [B, T_wav, 1], o_mb, spec, phase). `sid` is the JAX surface's
        speaker id; the ported model has one speaker, so it changes
        nothing."""
        if y_mask is not None:
            z = z * y_mask
        return self._decode(_cl(z))

    def decode_spec_tail(self, spec: torch.Tensor,
                         phase: torch.Tensor) -> torch.Tensor:
        """The decoder head's back half, (spec, phase) [B, F, s, bins] ->
        waveform [B, T_wav, 1]: the same code and filters as the forward
        pass, for the serving spectrogram-domain join."""
        return _cl(self.dec.spec_tail(spec.permute(0, 2, 3, 1),
                                      phase.permute(0, 2, 3, 1)))
