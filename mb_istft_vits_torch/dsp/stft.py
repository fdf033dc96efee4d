"""STFT, magnitude spectrogram and inverse STFT (counterpart of
`mb_istft_vits_tpu/dsp/stft.py`), on `torch.stft` / `torch.istft`.

  - `stft` / `stft_magnitude`: onesided STFT, periodic Hann window
    zero-padded to n_fft at the centre; center=True reflect-pads n_fft//2
    a side, as the MR-STFT loss does (reference `stft_loss.py:12-28`).
  - `spectrogram`: the training front end (reference
    `mel_processing.py:51-70`): constant-pad (n_fft - hop)/2 a side with
    zeros, then center=False. This fork of the reference pads with zeros,
    not by reflection.
  - `istft`: the decoder heads' inverse (`TorchSTFT.inverse`, reference
    `stft.py:197-202`) with center=True.
  - `hann_window` and `TorchSTFT`, the JAX package's stand-in for the
    reference's `TorchSTFT` (`transform` -> magnitude and phase,
    `inverse` -> [B, 1, T]).

torch.istft divides by the window's overlap-add envelope and raises where
the envelope vanishes inside the kept span; the JAX package divides by 1
there instead (`dsp/stft.py:302-304`). For the decoder heads (periodic
Hann, n_fft = 4 hops, center=True) the envelope has no zero in the kept
span, so the two agree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def hann_window(win_length: int,
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
    win = hann_window(win_length, device)
    left = (n_fft - win_length) // 2
    return F.pad(win, (left, n_fft - win_length - left))


def stft(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
         center: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Onesided STFT of y [B, T] (or [T]) -> (real, imag), each
    [B, n_bins, F]; center=True reflect-pads."""
    if y.dim() == 1:
        y = y[None]
    spec = torch.stft(y, n_fft, hop_length, n_fft,
                      window=padded_window(win_length, n_fft, y.device),
                      center=center, pad_mode="reflect", return_complex=True)
    return spec.real, spec.imag


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: int, center: bool = True, eps: float = 0.0
                   ) -> torch.Tensor:
    """|STFT| [B, n_bins, F]; eps > 0 clamps the power from below, as
    `stft_loss.py:28` does."""
    real, imag = stft(y, n_fft, hop_length, win_length, center)
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


def istft(magnitude: torch.Tensor, phase: torch.Tensor, n_fft: int,
          hop_length: int, win_length: int, center: bool = True
          ) -> torch.Tensor:
    """iSTFT of magnitude * e^{i phase}: [B, n_bins, F] -> [B, T], with
    T = (F - 1) * hop_length for center=True (JAX `istft` / `istft_riq`)."""
    spec = torch.polar(magnitude.float(), phase.float())
    wav = torch.istft(spec, n_fft, hop_length, n_fft,
                      window=padded_window(win_length, n_fft, spec.device),
                      center=center)
    return wav.to(magnitude.dtype)


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
