"""STFT, magnitude spectrogram and inverse STFT (counterpart of
`mb_istft_vits_tpu/dsp/stft.py`), on `torch.stft` and torch.istft's ops.

  - `stft` / `stft_magnitude`: onesided STFT, periodic Hann window
    zero-padded to n_fft at the centre; center=True pads n_fft//2 a side
    in `pad_mode` (reflect by default, as the MR-STFT loss does, reference
    `stft_loss.py:12-28`).
  - `spectrogram`: the training front end (reference
    `mel_processing.py:51-70`): constant-pad (n_fft - hop)/2 a side with
    zeros, then center=False. This fork of the reference pads with zeros,
    not by reflection.
  - `istft`, `istft_riq`, `overlap_add`: the decoder heads' inverse
    (`TorchSTFT.inverse`, reference `stft.py:197-202`) with center=True,
    from (magnitude, phase) or from frames-last (real | imag), and its
    overlap-add. The one inverse of the port, in training and serving.
  - `hann_window` and `TorchSTFT`, the JAX package's stand-in for the
    reference's `TorchSTFT` (`transform` -> magnitude and phase,
    `inverse` -> [B, 1, T]).

The inverse is torch.istft's own sequence of ops (irfft over the bins,
the window, the overlap-add as `unfold_backward`, the division by the
window's overlap-add envelope), so it gives torch.istft's bits, without
torch.istft's check of the envelope: that check reads the device from the
host, which a CUDA graph capture does not allow. Where the envelope
vanishes the signal is divided by 1, as the JAX package does
(`dsp/stft.py:302-304`); torch.istft would raise. The window and the
envelope are made once per (n_fft, hop, window, frames, device) and kept
on the device; a capture must find them made (the serving programs run
once eagerly before each capture).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from mb_istft_vits_torch.device import device_constant


# numpy's pad modes (what `jnp.pad` takes in the JAX package) in
# torch.stft's names; "reflect" and "constant" are the two the reference
# uses
_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "wrap": "circular"}


def hann_window(win_length: int, *,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """Periodic Hann window [win_length] in float32, as
    scipy.signal.get_window('hann', n, fftbins=True) at reference
    `stft.py:187`."""
    return torch.hann_window(win_length, periodic=True, dtype=torch.float32,
                             device=device)


def padded_window(win_length: int, n_fft: int,
                  device: torch.device) -> torch.Tensor:
    """Periodic Hann window of win_length, zero-padded at the centre of
    n_fft (JAX `_padded_window`; what torch.stft does to a short window)."""
    win = hann_window(win_length, device=device)
    left = (n_fft - win_length) // 2
    return F.pad(win, (left, n_fft - win_length - left))


def stft(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
         center: bool = True, pad_mode: str = "reflect"
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Onesided STFT of y [B, T] (or [T]) -> (real, imag), each
    [B, n_bins, F]. center=True pads n_fft // 2 a side in `pad_mode`, one
    of numpy's "reflect", "constant" (zeros), "edge" or "wrap"."""
    if pad_mode not in _PAD_MODES:
        raise ValueError(f"pad_mode {pad_mode!r} is not one of "
                         f"{sorted(_PAD_MODES)}")
    if y.dim() == 1:
        y = y[None]
    spec = torch.stft(y, n_fft, hop_length, n_fft,
                      window=padded_window(win_length, n_fft, y.device),
                      center=center, pad_mode=_PAD_MODES[pad_mode],
                      return_complex=True)
    return spec.real, spec.imag


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: int, center: bool = True,
                   pad_mode: str = "reflect", eps: float = 0.0
                   ) -> torch.Tensor:
    """|STFT| [B, n_bins, F]; eps > 0 clamps the power from below, as
    `stft_loss.py:28` does."""
    real, imag = stft(y, n_fft, hop_length, win_length, center, pad_mode)
    power = real * real + imag * imag
    if eps:
        power = torch.clamp(power, min=eps)
    return torch.sqrt(power)


def spectrogram(y: torch.Tensor, n_fft: int, hop_length: int,
                win_length: int) -> torch.Tensor:
    """Linear magnitude spectrogram of y [B, T] in [-1, 1] -> [B, n_bins, F]
    with the reference front end's zero padding."""
    if y.dim() == 1:
        y = y[None]
    p = (n_fft - hop_length) // 2
    return stft_magnitude(F.pad(y, (p, p)), n_fft, hop_length, win_length,
                          center=False)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add: frames [B, F, n_fft] -> [B, (F - 1) * hop + n_fft], each
    frame added in at a multiple of `hop` (JAX `overlap_add`). The sum of
    torch.istft: the gradient of `unfold`."""
    b, f, n_fft = frames.shape
    return torch.ops.aten.unfold_backward(
        frames, [b, (f - 1) * hop + n_fft], 1, n_fft, hop)


# (n_fft, hop, win_length, frames, device) -> (window [n_fft], envelope [T])
_SYNTHESIS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _synthesis_window(n_fft: int, hop_length: int, win_length: int,
                      frames: int, like: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(window [n_fft], overlap-add envelope [(frames - 1) * hop + n_fft]
    with 1 where it vanishes) on like's device, kept per shape and device
    (`device_constant`)."""
    def make():
        win = padded_window(win_length, n_fft, like.device)
        env = overlap_add(win.pow(2).expand(1, frames, n_fft),
                          hop_length)[0]
        return win, torch.where(env > torch.finfo(torch.float32).tiny, env,
                                torch.ones_like(env))

    return device_constant(_SYNTHESIS, (n_fft, hop_length, win_length,
                                        frames), like, make)


def _istft_frames(spec: torch.Tensor, n_fft: int, hop_length: int,
                  win_length: int, center: bool) -> torch.Tensor:
    """Frames-first onesided spectrum [B, F, n_bins] (complex64) ->
    float32 [B, T]: irfft, window, overlap-add, envelope, trim."""
    win, env = _synthesis_window(n_fft, hop_length, win_length,
                                 spec.shape[1], spec)
    frames = torch.fft.irfft(spec, n_fft, dim=-1) * win
    sig = overlap_add(frames, hop_length) / env
    if center:
        p = n_fft // 2
        sig = sig[:, p: sig.shape[1] - p]
    return sig


def istft_riq(riq: torch.Tensor, n_fft: int, hop_length: int,
              win_length: int, center: bool = True) -> torch.Tensor:
    """iSTFT of frames-last (real | imag) [B, F, 2 * n_bins] -> [B, T] in
    riq's dtype (computed in float32), T = (F - 1) * hop_length for
    center=True (JAX `istft_riq`)."""
    n_bins = n_fft // 2 + 1
    if riq.shape[-1] != 2 * n_bins:
        raise ValueError(f"riq has {riq.shape[-1]} values a frame, not "
                         f"2 * {n_bins} for n_fft {n_fft}")
    r = riq.float()
    spec = torch.complex(r[..., :n_bins], r[..., n_bins:])
    return _istft_frames(spec, n_fft, hop_length, win_length,
                         center).to(riq.dtype)


def istft(magnitude: torch.Tensor, phase: torch.Tensor, n_fft: int,
          hop_length: int, win_length: int, center: bool = True
          ) -> torch.Tensor:
    """iSTFT of magnitude * e^{i phase}: [B, n_bins, F] -> [B, T] in
    magnitude's dtype (computed in float32), T = (F - 1) * hop_length for
    center=True (JAX `istft`)."""
    spec = torch.polar(magnitude.float(), phase.float())
    return _istft_frames(spec.transpose(1, 2), n_fft, hop_length,
                         win_length, center).to(magnitude.dtype)


class TorchSTFT:
    """The reference's `TorchSTFT` (`stft.py:181-207`) as the JAX package
    has it: `transform(y [B, T])` -> (magnitude, phase), each
    [B, n_bins, F]; `inverse(magnitude, phase)` -> [B, 1, T]."""

    def __init__(self, filter_length: int = 800, hop_length: int = 200,
                 win_length: int = 800):
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length

    def transform(self, y: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        real, imag = stft(y, self.filter_length, self.hop_length,
                          self.win_length, center=True)
        return torch.sqrt(real * real + imag * imag), torch.atan2(imag, real)

    def inverse(self, magnitude: torch.Tensor, phase: torch.Tensor
                ) -> torch.Tensor:
        return istft(magnitude, phase, self.filter_length, self.hop_length,
                     self.win_length, center=True)[:, None, :]
