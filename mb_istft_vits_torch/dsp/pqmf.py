"""Pseudo-QMF filterbank of the MB-iSTFT head and the sub-band loss
(counterpart of `mb_istft_vits_tpu/dsp/pqmf.py`; reference
`pqmf.py:15-116`).

The filters are designed with numpy once. Both directions are the
reference's own pipeline: analysis is the 63-tap cosine-modulated
analysis filters as one conv1d, then every `subbands`-th sample;
synthesis zero-stuffs x subbands with gain `subbands`, then runs the
synthesis filters as one conv1d.

`PQMFBank` is the JAX package's name for the same filterbank; besides the
band-major `analysis_bm` / `synthesis_bm` that the decoder and the
sub-band loss use, it has JAX's channels-last `analysis` / `synthesis`.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def design_prototype_filter(taps: int = 62, cutoff_ratio: float = 0.15,
                            beta: float = 9.0) -> np.ndarray:
    """Kaiser-window lowpass prototype (reference `pqmf.py:15-43`)."""
    if taps % 2 != 0:
        raise ValueError("The number of taps must be even.")
    if not 0.0 < cutoff_ratio < 1.0:
        raise ValueError("cutoff_ratio must be in (0, 1)")
    omega_c = np.pi * cutoff_ratio
    n = np.arange(taps + 1) - 0.5 * taps
    with np.errstate(invalid="ignore"):
        h_i = np.sin(omega_c * n) / (np.pi * n)
    h_i[taps // 2] = cutoff_ratio  # sinc(0) limit
    return h_i * np.kaiser(taps + 1, beta)


@functools.lru_cache(maxsize=None)
def _pqmf_filters(subbands: int, taps: int, cutoff_ratio: float,
                  beta: float) -> Tuple[np.ndarray, np.ndarray]:
    """Cosine-modulated analysis/synthesis filters, each [subbands, taps+1]
    (reference `pqmf.py:64-75`)."""
    h_proto = design_prototype_filter(taps, cutoff_ratio, beta)
    n = np.arange(taps + 1)
    h_analysis = np.zeros((subbands, taps + 1))
    h_synthesis = np.zeros((subbands, taps + 1))
    for k in range(subbands):
        mod = (2 * k + 1) * (np.pi / (2 * subbands)) * (n - (taps - 1) / 2)
        h_analysis[k] = 2 * h_proto * np.cos(mod + (-1) ** k * np.pi / 4)
        h_synthesis[k] = 2 * h_proto * np.cos(mod - (-1) ** k * np.pi / 4)
    return h_analysis.astype(np.float32), h_synthesis.astype(np.float32)


class PQMF(nn.Module):
    """PQMF analysis and synthesis. The filters are non-persistent
    buffers: they move with the module but are not part of the state dict
    (the reference rebuilds them in its constructor too)."""

    def __init__(self, subbands: int = 4, taps: int = 62,
                 cutoff_ratio: float = 0.15, beta: float = 9.0):
        super().__init__()
        self.subbands, self.taps = subbands, taps
        h_a, h_s = _pqmf_filters(subbands, taps, cutoff_ratio, beta)
        self.register_buffer("analysis_filter",  # [s, 1, taps+1]
                             torch.from_numpy(h_a.copy())[:, None],
                             persistent=False)
        self.register_buffer("synthesis_filter",
                             torch.from_numpy(h_s.copy())[None],  # [1, s, taps+1]
                             persistent=False)

    def analysis_bm(self, x: torch.Tensor) -> torch.Tensor:
        """Waveform [B, 1, T] -> band-major sub-bands [B, S, ceil(T/S)]
        (reference `pqmf.py:95-103`)."""
        half = self.taps // 2
        bands = F.conv1d(F.pad(x, (half, half)),
                         self.analysis_filter.to(x.dtype))
        return bands[:, :, ::self.subbands]

    def synthesis_bm(self, x: torch.Tensor) -> torch.Tensor:
        """Band-major sub-band waveforms [B, S, T/S] -> [B, 1, T]
        (reference `pqmf.py:105-116`)."""
        b, s, t = x.shape
        up = x.new_zeros((b, s, t * s))
        up[:, :, ::s] = x * s
        half = self.taps // 2
        return F.conv1d(F.pad(up, (half, half)),
                        self.synthesis_filter.to(x.dtype))

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """Channels-last: waveform [B, T, 1] -> sub-bands
        [B, ceil(T/S), S] (JAX `PQMFBank.analysis`)."""
        return self.analysis_bm(x.transpose(1, 2)).transpose(1, 2)

    def synthesis(self, x: torch.Tensor) -> torch.Tensor:
        """Channels-last: sub-bands [B, T/S, S] -> waveform [B, T, 1]
        (JAX `PQMFBank.synthesis`)."""
        return self.synthesis_bm(x.transpose(1, 2)).transpose(1, 2)


PQMFBank = PQMF
