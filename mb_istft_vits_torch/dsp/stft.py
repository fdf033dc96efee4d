"""Inverse STFT of the decoder heads (counterpart of the iSTFT half of
`mb_istft_vits_tpu/dsp/stft.py`; `TorchSTFT.inverse`, reference
`stft.py:197-202`): `torch.istft` with center=True and a periodic Hann
window, as the reference computes it.

torch.istft divides by the window's overlap-add envelope and raises where
the envelope vanishes inside the kept span; the JAX package divides by 1
there instead (`dsp/stft.py:302-304`). For the decoder heads (periodic
Hann, n_fft = 4 hops, center=True) the envelope has no zero in the kept
span, so the two agree.
"""

from __future__ import annotations

import torch


def istft(magnitude: torch.Tensor, phase: torch.Tensor, n_fft: int,
          hop_length: int, win_length: int, center: bool = True
          ) -> torch.Tensor:
    """iSTFT of magnitude * e^{i phase}: [B, n_bins, F] -> [B, T], with
    T = (F - 1) * hop_length for center=True (JAX `istft` / `istft_riq`)."""
    spec = torch.polar(magnitude.float(), phase.float())
    win = torch.hann_window(win_length, periodic=True, dtype=torch.float32,
                            device=spec.device)
    left = (n_fft - win_length) // 2  # centred, as torch.istft pads
    win = torch.nn.functional.pad(win, (left, n_fft - win_length - left))
    wav = torch.istft(spec, n_fft, hop_length, win_length, window=win,
                      center=center)
    return wav.to(magnitude.dtype)
