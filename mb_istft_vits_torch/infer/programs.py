"""The serving programs' bodies (counterpart of the functions that
`mb_istft_vits_tpu/infer/synthesis.py` jits: `_build_infer`,
`_build_latents`, `_build_decode`, `_build_decode_spec`,
`_build_spec_tail` and the duration probe).

Each body is a plain function of the model and tensors: the knobs are
0-dim float32 tensors (or Python floats), the noise is an input, and no
branch reads the device, so a body can be captured as a CUDA graph
(`infer.graphs`) or exported (`infer.export`) and gives the bits of its
direct call either way. Shapes and options that fix the program
(`max_frames`, `resample`, `want_z`) are keywords.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mb_istft_vits_torch.dsp.resample import resample_poly_torch


def _pcm16(o: torch.Tensor) -> torch.Tensor:
    """Waveform [..., T, 1] -> int16 PCM [..., T], rounded on the device."""
    pcm = torch.clamp(o[..., 0].float(), -1.0, 1.0)
    return torch.round(pcm * 32767.0).to(torch.int16)


def probe(model, x, x_lengths, sid, length_scale, noise_scale_w, w_eps):
    """The duration probe: -> predicted frames [B] (int32)."""
    return model.predict_frames(x, x_lengths, sid, length_scale,
                                noise_scale_w, w_eps=w_eps)


def infer(model, x, x_lengths, sid, noise_scale, length_scale,
          noise_scale_w, eps, w_eps, max_frames: int,
          resample: Optional[Tuple[int, int]] = None, want_z: bool = False):
    """Text -> (int16 PCM [B, T_wav], y_lengths [B]) at `max_frames`
    frames, resampled (sr_in, sr_out) first when `resample` is given; with
    `want_z` also z [B, max_frames, C]. eps [B, max_frames, C] is the
    prior's noise, w_eps [B, T_x, 2] the stochastic predictor's (or
    None)."""
    out = model.infer(x, x_lengths, sid, noise_scale, length_scale,
                      noise_scale_w, max_frames, eps=eps, w_eps=w_eps)
    o = out.o
    if resample is not None:
        o = resample_poly_torch(o, *resample)
    res = (_pcm16(o), out.y_lengths)
    return res + (out.latents[0],) if want_z else res


def latents(model, x, x_lengths, sid, noise_scale, length_scale,
            noise_scale_w, eps, w_eps, max_frames: int):
    """Latents only, at `max_frames`: -> (z [B, max_frames, C], y_lengths
    [B], frames per token [B, T_x])."""
    attn, _, y_lengths, (z, *_) = model.infer_z_only(
        x, x_lengths, sid, noise_scale, length_scale, noise_scale_w,
        max_frames, eps=eps, w_eps=w_eps)
    return z, y_lengths, attn.sum(dim=1)


def decode_pcm(model, z, sid):
    """z windows [N, T, C] -> int16 PCM [N, T * hop]."""
    return _pcm16(model.decode(z, sid)[0])


def decode_spec(model, z, sid):
    """z windows [N, T, C] -> the head's (spec, phase)."""
    _, _, spec, phase = model.decode(z, sid)
    return spec, phase


def spec_tail(model, spec, phase):
    """A joined (spec, phase) [B, F, ...] -> waveform [B, T_wav]."""
    return model.decode_spec_tail(spec, phase)[..., 0]
