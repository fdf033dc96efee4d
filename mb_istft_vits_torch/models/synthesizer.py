"""Top-level VITS synthesizer: training forward, inference, latent-only
inference, decoder-only decode, copy-synthesis and voice conversion
(counterpart of `mb_istft_vits_tpu/models/synthesizer.py`; reference
`models.py:568-798`).

Modules run in [B, C, T]; the public methods take and return the JAX
package's channels-last layouts ([B, T, C], waveforms [B, T_wav, 1],
alignments [B, T_y, T_x]), so the two packages compare like with like,
and take JAX's parameters in JAX's positional order.

Randomness is explicit: `forward`, `fake_slice`, `reconstruct` and
`voice_conversion` take the posterior noise and the slice starts, `infer`
the prior noise `eps`, as keyword-only tensors; a model with the
stochastic duration predictor (`use_sdp`) also takes its noise, `sdp_eps`
in `forward` and `w_eps` (scaled by `noise_scale_w`) in `predict_frames`
and the inference methods. Whatever is not given is drawn from the
keyword-only `generator`, `w_eps` before `eps`, as the JAX package's
first "noise" draw in `infer` is the predictor's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from mb_istft_vits_torch.config import ModelConfig
from mb_istft_vits_torch.models.decoders import (
    ISTFTGenerator,
    MultibandISTFTGenerator,
    MultistreamISTFTGenerator,
)
from mb_istft_vits_torch.models.duration import (
    DurationPredictor,
    StochasticDurationPredictor,
)
from mb_istft_vits_torch.models.encoders import PosteriorEncoder, TextEncoder
from mb_istft_vits_torch.nn.flows import Flip, ResidualCouplingLayer
from mb_istft_vits_torch.ops import (
    generate_path,
    maximum_path,
    rand_slice_segments,
    sequence_mask,
)

_DECODERS = {"istft": ISTFTGenerator, "mb_istft": MultibandISTFTGenerator,
             "ms_istft": MultistreamISTFTGenerator}


def _cl(x: torch.Tensor) -> torch.Tensor:
    """[B, C, T] <-> [B, T, C]."""
    return x.transpose(1, 2)


def _spec_to_jax(x: torch.Tensor) -> torch.Tensor:
    """A head's spec or phase to JAX's layout: [B, s, bins, T'] ->
    [B, T', s, bins] (sub-band heads), [B, bins, T'] -> [B, T', bins]
    (the iSTFT head)."""
    return x.permute(0, 3, 1, 2) if x.dim() == 4 else _cl(x)


def _spec_from_jax(x: torch.Tensor) -> torch.Tensor:
    """The inverse of `_spec_to_jax`."""
    return x.permute(0, 2, 3, 1) if x.dim() == 4 else _cl(x)


class ResidualCouplingBlock(nn.Module):
    """4 x (affine coupling + Flip), invertible (reference models.py:184-214)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate,
                n_layers, gin_channels=gin_channels, mean_only=True))
            self.flows.append(Flip())

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                reverse: bool = False) -> torch.Tensor:
        if not reverse:
            for flow in self.flows:
                x = flow(x) if isinstance(flow, Flip) else flow(x, x_mask, g)[0]
        else:
            for flow in reversed(self.flows):
                x = flow(x) if isinstance(flow, Flip) else \
                    flow(x, x_mask, g, reverse=True)
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
    o: torch.Tensor                 # [B, T_wav, 1]
    # mb_istft: sub-band waveforms [B, s, T_band]; ms_istft: the
    # zero-stuffed synthesis-conv input [B, s, T_band * s]; istft: None
    o_mb: Optional[torch.Tensor]
    spec: torch.Tensor              # [B, T', s, bins] ([B, T', bins]: istft)
    phase: torch.Tensor             # as spec
    attn: torch.Tensor              # [B, max_frames, T_x]
    y_mask: torch.Tensor            # [B, max_frames, 1]
    y_lengths: torch.Tensor         # [B] frames
    latents: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class Synthesizer(nn.Module):
    """SynthesizerTrn equivalent (reference models.py:568-798) with the
    deterministic or (`use_sdp`) the stochastic duration predictor, any of
    the three decoder heads, and a speaker embedding `emb_g` when the
    model has more than one speaker."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        gin = cfg.gin_channels
        self.enc_p = TextEncoder(
            cfg.n_vocab, cfg.inter_channels, cfg.hidden_channels,
            cfg.filter_channels, cfg.n_heads, cfg.n_layers, cfg.kernel_size,
            cfg.p_dropout)
        kind = cfg.decoder_kind
        head = () if kind == "istft" else (cfg.subbands,)
        self.dec = _DECODERS[kind](
            cfg.inter_channels, cfg.resblock, cfg.resblock_kernel_sizes,
            cfg.resblock_dilation_sizes, cfg.upsample_rates,
            cfg.upsample_initial_channel, cfg.upsample_kernel_sizes,
            cfg.gen_istft_n_fft, cfg.gen_istft_hop_size, *head,
            gin_channels=gin)
        self.enc_q = PosteriorEncoder(cfg.spec_channels, cfg.inter_channels,
                                      cfg.hidden_channels, 5, 1, 16,
                                      gin_channels=gin)
        self.flow = ResidualCouplingBlock(cfg.inter_channels,
                                          cfg.hidden_channels, 5, 1, 4,
                                          gin_channels=gin)
        if cfg.use_sdp:
            self.dp = StochasticDurationPredictor(cfg.hidden_channels, 192, 3,
                                                  0.5, 4, gin_channels=gin)
        else:
            self.dp = DurationPredictor(cfg.hidden_channels, 256, 3, 0.5,
                                        gin_channels=gin)
        if cfg.n_speakers > 1:
            self.emb_g = nn.Embedding(cfg.n_speakers, gin)

    def _speaker(self, sid: Optional[torch.Tensor]
                 ) -> Optional[torch.Tensor]:
        """sid [B] -> g [B, gin, 1]; None for a model of 0 or 1 speakers,
        whatever `sid` is (JAX `_speaker`)."""
        if self.cfg.n_speakers > 1 and sid is not None:
            return self.emb_g(sid.long()).unsqueeze(-1)
        return None

    def _check_mode(self, train: Optional[bool]) -> None:
        """JAX's `train` selects dropout; here `self.training` does, so a
        `train` that disagrees with it is an error, not a silent no-op."""
        if train is not None and bool(train) != self.training:
            raise ValueError(
                f"train={train} but the module is in "
                f"{'train' if self.training else 'eval'} mode; dropout "
                "follows .train() / .eval()")

    def _decode(self, z: torch.Tensor, g: Optional[torch.Tensor]):
        """Decoder on [B, C, T]; outputs in the JAX layouts."""
        o, o_mb, spec, phase = self.dec(z, g)
        return _cl(o), o_mb, _spec_to_jax(spec), _spec_to_jax(phase)

    def _posterior(self, y, y_lengths, g, posterior_eps, generator):
        return self.enc_q(
            _cl(y), y_lengths, g,
            noise_rng=generator,
            eps=None if posterior_eps is None else _cl(posterior_eps))

    # ------------------------------------------------------------------
    # training forward (reference models.py:657-695)
    # ------------------------------------------------------------------
    def forward(
        self,
        x: torch.Tensor,
        x_lengths: torch.Tensor,
        y: torch.Tensor,
        y_lengths: torch.Tensor,
        sid: Optional[torch.Tensor] = None,
        train: Optional[bool] = None,
        *,
        posterior_eps: Optional[torch.Tensor] = None,
        ids_slice: Optional[torch.Tensor] = None,
        sdp_eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        mas_force: str = "auto",
    ):
        """x [B, T_x] ids, y [B, T_y, spec] linear spectrogram, sid [B]
        speaker ids, posterior_eps [B, T_y, C], sdp_eps [B, T_x, 2] (the
        stochastic duration predictor's posterior noise). Dropout follows
        `self.training` (`train`, if given, must agree). mas_force is
        `ops.mas.maximum_path(force=)`: "auto" takes the fused kernel
        whenever its shared memory fits, which on an H100 is every
        training shape, so "two_pass" is how a run reaches the two-pass
        kernels.

        Returns the JAX package's tuple: (o [B, seg*hop, 1], o_mb,
        l_length [B], attn [B, T_y, T_x], ids_slice [B], x_mask [B, T_x, 1],
        y_mask [B, T_y, 1], (z, z_p, m_p, logs_p, m_q, logs_q) each
        [B, T, C])."""
        self._check_mode(train)
        cfg = self.cfg
        h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths)
        g = self._speaker(sid)
        z, m_q, logs_q, y_mask = self._posterior(y, y_lengths, g,
                                                 posterior_eps, generator)
        z_p = self.flow(z, y_mask, g)

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
        if cfg.use_sdp:
            l_length = self.dp(
                h, x_mask, w.to(h.dtype), g,
                noise_rng=generator,
                noise=None if sdp_eps is None else _cl(sdp_eps),
                ).float() / torch.sum(x_mask32)
        else:
            logw_ = torch.log(w + 1e-6) * x_mask32
            logw = self.dp(h, x_mask, g).float()
            l_length = torch.sum((logw - logw_) ** 2, dim=(1, 2)) / torch.sum(
                x_mask32)

        # expand the prior over frames (reference models.py:690-691)
        m_p = torch.matmul(m_p, _cl(attn))
        logs_p = torch.matmul(logs_p, _cl(attn))

        z_slice, ids_slice = rand_slice_segments(
            z, generator, y_lengths, cfg.segment_size, ids_str=ids_slice)
        o, o_mb, _, _ = self._decode(z_slice, g)
        return (o, o_mb, l_length, attn, ids_slice, _cl(x_mask), _cl(y_mask),
                tuple(_cl(t) for t in (z, z_p, m_p, logs_p, m_q, logs_q)))

    def fake_slice(
        self,
        y: torch.Tensor,
        y_lengths: torch.Tensor,
        sid: Optional[torch.Tensor] = None,
        train: Optional[bool] = None,
        *,
        posterior_eps: Optional[torch.Tensor] = None,
        ids_slice: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """The part of `forward` that makes the discriminator's fake:
        posterior -> random slice -> decoder. Under the same draws its
        output is `forward`'s (o, ids_slice). The trainer runs one full
        forward per step instead, as the reference does; this stays for
        callers that need only the fake."""
        self._check_mode(train)
        g = self._speaker(sid)
        z, _, _, _ = self._posterior(y, y_lengths, g, posterior_eps,
                                     generator)
        z_slice, ids_slice = rand_slice_segments(
            z, generator, y_lengths, self.cfg.segment_size,
            ids_str=ids_slice)
        return self._decode(z_slice, g)[0], ids_slice

    # ------------------------------------------------------------------
    # inference (reference models.py:697-737)
    # ------------------------------------------------------------------
    def _duration_head(self, x, x_lengths, sid, length_scale, noise_scale_w,
                       w_eps, generator):
        """Text encoder + duration predictor + ceil: the one definition of
        predicted durations, shared by `predict_frames` and `infer`. The
        stochastic predictor samples its durations from `w_eps`
        [B, T_x, 2] (drawn from `generator` when None) scaled by
        `noise_scale_w`; the serving probe and the decode agree only when
        they are handed the same `w_eps`."""
        h, m_p, logs_p, x_mask = self.enc_p(x, x_lengths)
        g = self._speaker(sid)
        if self.cfg.use_sdp:
            logw = self.dp(h, x_mask, g=g, reverse=True,
                           noise_scale=noise_scale_w,
                           noise_rng=generator,
                           noise=None if w_eps is None else _cl(w_eps))
        else:
            logw = self.dp(h, x_mask, g)
        # exp(logw) in the compute dtype, the product and ceil in float32,
        # as the JAX serving programs compute them (their length_scale is
        # a float32 scalar, which promotes the product); so the frame sums
        # are exact (a bf16 sum would round totals past 256 frames)
        w_ceil = torch.ceil(torch.exp(logw).float() * x_mask
                            * length_scale)
        y_lengths = torch.clamp(torch.sum(w_ceil, dim=(1, 2)), min=1.0)
        return m_p, logs_p, x_mask, g, w_ceil, y_lengths.to(torch.int32)

    def _infer_latents(self, x, x_lengths, sid, noise_scale, length_scale,
                       noise_scale_w, max_frames, eps, w_eps, generator):
        m_p, logs_p, x_mask, g, w_ceil, y_lengths = self._duration_head(
            x, x_lengths, sid, length_scale, noise_scale_w, w_eps, generator)
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
        else:  # in the compute dtype, as JAX draws it in m_p's
            eps = _cl(eps).to(m_p.dtype)
        z_p = m_p + eps * torch.exp(logs_p) * noise_scale
        z = self.flow(z_p, y_mask, g, reverse=True)
        return z, z_p, m_p, logs_p, attn, y_mask, y_lengths, g

    def predict_frames(self, x: torch.Tensor, x_lengths: torch.Tensor,
                       sid: Optional[torch.Tensor] = None,
                       length_scale: float = 1.0,
                       noise_scale_w: float = 1.0, *,
                       w_eps: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
        """Total predicted frames per utterance [B] (text encoder +
        duration predictor only); `infer` under the same `w_eps` decodes
        exactly these."""
        return self._duration_head(x, x_lengths, sid, length_scale,
                                   noise_scale_w, w_eps, generator)[-1]

    def infer(
        self,
        x: torch.Tensor,
        x_lengths: torch.Tensor,
        sid: Optional[torch.Tensor] = None,
        noise_scale: float = 1.0,
        length_scale: float = 1.0,
        noise_scale_w: float = 1.0,
        max_frames: Optional[int] = 1000,
        *,
        eps: Optional[torch.Tensor] = None,
        w_eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> InferOutput:
        """Text -> waveform. `max_frames` bounds the output frames as in the
        JAX package; None sizes it to the longest predicted utterance.
        `eps` [B, max_frames, C] is the prior noise, `w_eps` [B, T_x, 2]
        the stochastic duration predictor's."""
        z, z_p, m_p, logs_p, attn, y_mask, y_lengths, g = \
            self._infer_latents(x, x_lengths, sid, noise_scale, length_scale,
                                noise_scale_w, max_frames, eps, w_eps,
                                generator)
        o, o_mb, spec, phase = self._decode(z * y_mask, g)
        return InferOutput(o, o_mb, spec, phase, attn, _cl(y_mask), y_lengths,
                           tuple(_cl(t) for t in (z, z_p, m_p, logs_p)))

    def infer_z_only(
        self,
        x: torch.Tensor,
        x_lengths: torch.Tensor,
        sid: Optional[torch.Tensor] = None,
        noise_scale: float = 1.0,
        length_scale: float = 1.0,
        noise_scale_w: float = 1.0,
        max_frames: Optional[int] = 1000,
        *,
        eps: Optional[torch.Tensor] = None,
        w_eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Latents only: (attn, y_mask, y_lengths, (z, z_p, m_p, logs_p))
        (reference models.py:742-788)."""
        z, z_p, m_p, logs_p, attn, y_mask, y_lengths, _ = \
            self._infer_latents(x, x_lengths, sid, noise_scale, length_scale,
                                noise_scale_w, max_frames, eps, w_eps,
                                generator)
        return (attn, _cl(y_mask), y_lengths,
                tuple(_cl(t) for t in (z, z_p, m_p, logs_p)))

    def decode(self, z: torch.Tensor, sid: Optional[torch.Tensor] = None,
               y_mask: Optional[torch.Tensor] = None):
        """Decoder only: z [B, T, C] (y_mask [B, T, 1]) ->
        (o [B, T_wav, 1], o_mb, spec, phase), conditioned on `sid`."""
        if y_mask is not None:
            z = z * y_mask
        return self._decode(_cl(z), self._speaker(sid))

    def decode_spec_tail(self, spec: torch.Tensor,
                         phase: torch.Tensor) -> torch.Tensor:
        """The decoder head's back half, (spec, phase) [B, F, s, bins]
        ([B, F, bins] for the iSTFT head) -> waveform [B, T_wav, 1]: the
        same code and filters as the forward pass, for the serving
        spectrogram-domain join."""
        return _cl(self.dec.spec_tail(_spec_from_jax(spec),
                                      _spec_from_jax(phase)))

    # ------------------------------------------------------------------
    # copy-synthesis and voice conversion (reference models.py:790-798)
    # ------------------------------------------------------------------
    def reconstruct(
        self,
        y: torch.Tensor,
        y_lengths: torch.Tensor,
        sid: Optional[torch.Tensor] = None,
        *,
        posterior_eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Copy-synthesis: the posterior of the spectrogram y [B, T, spec]
        decoded back to a waveform, time-aligned with y ->
        (o [B, T * hop, 1], y_mask [B, T, 1])."""
        g = self._speaker(sid)
        z, _, _, y_mask = self._posterior(y, y_lengths, g, posterior_eps,
                                          generator)
        return self._decode(z * y_mask, g)[0], _cl(y_mask)

    def voice_conversion(
        self,
        y: torch.Tensor,
        y_lengths: torch.Tensor,
        sid_src: torch.Tensor,
        sid_tgt: torch.Tensor,
        *,
        posterior_eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Latent-space speaker swap: the posterior under `sid_src`
        through the flow, back through it under `sid_tgt`, decoded as
        `sid_tgt` -> (o_hat [B, T * hop, 1], o_hat_mb, y_mask [B, T, 1],
        (z, z_p, z_hat) each [B, T, C])."""
        if self.cfg.n_speakers <= 1:
            raise ValueError(
                "voice conversion needs a multi-speaker model (n_speakers > 1)")
        g_src, g_tgt = self._speaker(sid_src), self._speaker(sid_tgt)
        z, _, _, y_mask = self._posterior(y, y_lengths, g_src, posterior_eps,
                                          generator)
        z_p = self.flow(z, y_mask, g_src)
        z_hat = self.flow(z_p, y_mask, g_tgt, reverse=True)
        o_hat, o_hat_mb, _, _ = self._decode(z_hat * y_mask, g_tgt)
        return o_hat, o_hat_mb, _cl(y_mask), (_cl(z), _cl(z_p), _cl(z_hat))
