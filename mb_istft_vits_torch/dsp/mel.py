"""Mel front end of the mel loss (counterpart of
`mb_istft_vits_tpu/dsp/mel.py`; reference `mel_processing.py:51-112`):
the Slaney-scale mel filterbank of librosa.filters.mel (htk=False,
norm='slaney'), designed once with numpy, and log(clamp(x, 1e-5))."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from mb_istft_vits_torch.dsp.stft import spectrogram

_F_SP = 200.0 / 3  # Hz per mel below 1 kHz
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    return np.where(
        f >= _MIN_LOG_HZ,
        _MIN_LOG_MEL + np.log(np.maximum(f, 1e-10) / _MIN_LOG_HZ) / _LOGSTEP,
        f / _F_SP)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    _F_SP * m)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sampling_rate: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: Optional[float]) -> np.ndarray:
    """Slaney-normalized triangular filters [n_mels, n_fft // 2 + 1]
    (librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax), as the reference
    calls it at `mel_processing.py:78,96`). Read-only: it is shared."""
    if fmax is None:
        fmax = sampling_rate / 2.0
    fftfreqs = np.linspace(0.0, sampling_rate / 2.0, n_fft // 2 + 1)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                     n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels]))[:, None]
    weights = weights.astype(np.float32)
    weights.flags.writeable = False
    return weights


@functools.lru_cache(maxsize=16)
def _basis(sampling_rate: int, n_fft: int, n_mels: int, fmin: float,
           fmax: Optional[float], device: torch.device) -> torch.Tensor:
    """`mel_filterbank` on `device`, copied there once (a copy from host
    memory in every step would make the host wait for the device)."""
    return torch.from_numpy(np.array(mel_filterbank(
        sampling_rate, n_fft, n_mels, fmin, fmax))).to(device)


def spectral_normalize(x: torch.Tensor, clip_val: float = 1e-5
                       ) -> torch.Tensor:
    """Log dynamic-range compression (reference `mel_processing.py:19-39`)."""
    return torch.log(torch.clamp(x, min=clip_val))


def spec_to_mel(spec: torch.Tensor, n_fft: int, num_mels: int,
                sampling_rate: int, fmin: float, fmax: Optional[float]
                ) -> torch.Tensor:
    """Linear spectrogram [B, n_bins, F] -> log-mel [B, n_mels, F]
    (reference `mel_processing.py:73-82`)."""
    basis = _basis(sampling_rate, n_fft, num_mels, fmin, fmax, spec.device)
    return spectral_normalize(torch.matmul(basis.to(spec.dtype), spec))


def mel_spectrogram(y: torch.Tensor, n_fft: int, num_mels: int,
                    sampling_rate: int, hop_size: int, win_size: int,
                    fmin: float, fmax: Optional[float]) -> torch.Tensor:
    """Waveform [B, T] -> log-mel [B, n_mels, F] (reference
    `mel_processing.py:85-112`)."""
    return spec_to_mel(spectrogram(y, n_fft, hop_size, win_size), n_fft,
                       num_mels, sampling_rate, fmin, fmax)
