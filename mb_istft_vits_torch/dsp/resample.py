"""Windowed-sinc polyphase resampler (the port's copy of
`mb_istft_vits_tpu/dsp/resample.py`).

- :func:`design_resample_filter`, :func:`resample_poly` and
  :class:`PolyphaseStreamResampler` are numpy and copied as they are:
  exact rational L/M polyphase with a Kaiser windowed-sinc lowpass,
  centred (zero group delay), output length ``ceil(T * L / M)``.
- :func:`resample_poly_torch` is the batched on-device path that the JAX
  package writes as one convolution with ``lhs_dilation=L``. That form
  multiplies mostly zeros (at 22050 -> 48000, L = 320 and the "fast" filter
  has 10,241 taps). Here the same sum is taken in polyphase form: output
  ``r + L m`` of phase ``r`` reads the input window starting at ``M m``, so
  all L phases are one matmul of the strided input windows (an ``unfold``)
  with an [L, W] matrix holding each phase's taps at its offset, in f32.

Quality presets mirror librosa's two kaiser modes: ``"best"``
(64 zero-crossings, beta 14.77, rolloff 0.9475) and ``"fast"``
(16 zero-crossings, beta 8.556, rolloff 0.85).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mb_istft_vits_torch.device import device_constant

_PRESETS = {
    # name: (zero_crossings, kaiser beta, rolloff)
    "best": (64, 14.769656459379492, 0.9475937167399596),
    "fast": (16, 8.555504641634386, 0.85),
}


def _rational(sr_in: int, sr_out: int) -> Tuple[int, int]:
    g = math.gcd(int(sr_in), int(sr_out))
    return int(sr_out) // g, int(sr_in) // g  # L (up), M (down)


@functools.lru_cache(maxsize=None)
def design_resample_filter(
    L: int, M: int, quality: str = "fast"
) -> np.ndarray:
    """Kaiser windowed-sinc lowpass for an L-up / M-down polyphase
    resampler, gain L, odd length (integer group delay). Cutoff is the
    tighter of the two Nyquist constraints in the L-upsampled domain,
    pulled in by the preset's rolloff."""
    zeros, beta, rolloff = _PRESETS[quality]
    denom = max(L, M)
    # cutoff in cycles/sample of the upsampled rate; 0.5/denom is Nyquist
    fc = rolloff * 0.5 / denom
    half = zeros * denom  # taps each side; sinc zero-crossings every 1/(2fc)
    n = np.arange(-half, half + 1, dtype=np.float64)
    h = 2.0 * fc * np.sinc(2.0 * fc * n)
    h *= np.kaiser(2 * half + 1, beta)
    # gain L compensates the L-fold zero-stuffing (normalize DC exactly)
    h *= L / np.sum(h)
    return h.astype(np.float64)


def _out_len(T: int, L: int, M: int) -> int:
    return -(-T * L // M)  # ceil


def _phase_bank(h: np.ndarray, L: int) -> np.ndarray:
    """Per-phase filter bank [L, K]: phase p uses h[p], h[p+L], ..."""
    K = -(-len(h) // L)
    hp = np.zeros((L, K), np.float64)
    for p in range(L):
        taps = h[p::L]
        hp[p, : len(taps)] = taps
    return hp


def resample_poly(
    x: np.ndarray, sr_in: int, sr_out: int, quality: str = "fast"
) -> np.ndarray:
    """Resample the 1-D signal ``x`` from ``sr_in`` to ``sr_out``.
    Returns float32 of length ``ceil(len(x) * L / M)``."""
    x = np.asarray(x, np.float64)
    if sr_in == sr_out:
        return x.astype(np.float32)
    L, M = _rational(sr_in, sr_out)
    h = design_resample_filter(L, M, quality)
    D = (len(h) - 1) // 2  # integer group delay in upsampled samples
    hp = _phase_bank(h, L)
    K = hp.shape[1]
    T = len(x)
    n = np.arange(_out_len(T, L, M))
    j = n * M + D
    p = j % L
    q = j // L
    # y[n] = sum_k h[p + k*L] * x[q - k]
    idx = q[:, None] - np.arange(K)[None, :]
    valid = (idx >= 0) & (idx < T)
    xg = np.where(valid, x[np.clip(idx, 0, T - 1)], 0.0)
    y = np.einsum("nk,nk->n", xg, hp[p])
    return y.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _phase_matrix(L: int, M: int, quality: str) -> Tuple[np.ndarray, int]:
    """-> (W [L, width] float32, s_min) such that output r + L m of the
    resampler is sum_w W[r, w] * x[M m + s_min + w] (x zero outside).

    Output n = r + L m has j = n M + D, phase p_r = (r M + D) % L and
    newest input q_r + M m with q_r = (r M + D) // L; its K taps read
    x[q_r + M m - k]. Every phase's window lies inside
    [q_0 - K + 1, q_{L-1}] relative to M m."""
    h = design_resample_filter(L, M, quality)
    D = (len(h) - 1) // 2
    hp = _phase_bank(h, L)
    K = hp.shape[1]
    r = np.arange(L)
    j = r * M + D
    p, q = j % L, j // L
    s_min = int(q[0]) - K + 1
    width = int(q[-1]) - s_min + 1
    W = np.zeros((L, width), np.float64)
    for i in range(L):
        off = int(q[i]) - s_min  # column of tap k = 0
        W[i, off - K + 1: off + 1] = hp[p[i]][::-1]
    return W.astype(np.float32), s_min


# (L, M, quality, device) -> the transposed phase matrix [width, L]
_PHASE_MATRICES: Dict[tuple, torch.Tensor] = {}


def resample_poly_torch(x: torch.Tensor, sr_in: int, sr_out: int,
                        quality: str = "fast") -> torch.Tensor:
    """Batched resample of ``x [B, T, C]`` from ``sr_in`` to ``sr_out`` on
    x's device, in f32: [B, ceil(T L / M), C]. The same sum as
    :func:`resample_poly` per channel, in polyphase form (module
    docstring); the taps are uploaded once per rate pair and device
    (`device_constant`)."""
    if sr_in == sr_out:
        return x
    L, M = _rational(sr_in, sr_out)
    W_np, s_min = _phase_matrix(L, M, quality)
    width = W_np.shape[1]
    W = device_constant(_PHASE_MATRICES, (L, M, quality), x,
                        lambda: torch.from_numpy(W_np).to(x.device).t())
    B, T, C = x.shape
    n_out = _out_len(T, L, M)
    n_m = -(-n_out // L)  # window starts M m, m < n_m
    pad_l = -s_min
    pad_r = max(M * (n_m - 1) + width - pad_l - T, 0)
    xs = F.pad(x.float().transpose(1, 2), (pad_l, pad_r))  # [B, C, T']
    frames = xs.unfold(-1, width, M)[:, :, :n_m]  # [B, C, n_m, width]
    y = torch.matmul(frames, W)  # [B, C, n_m, L]
    return y.reshape(B, C, n_m * L)[:, :, :n_out].transpose(1, 2)


class PolyphaseStreamResampler:
    """Chunk-wise polyphase resampler with carried state.

    Feeding chunks then calling :meth:`flush` yields exactly
    ``resample_poly(concat(chunks), sr_in, sr_out, quality)``.
    """

    def __init__(self, sr_in: int, sr_out: int, quality: str = "fast"):
        self.sr_in, self.sr_out = int(sr_in), int(sr_out)
        self.identity = sr_in == sr_out
        if self.identity:
            return
        self.L, self.M = _rational(sr_in, sr_out)
        h = design_resample_filter(self.L, self.M, quality)
        self.D = (len(h) - 1) // 2
        self._hp = _phase_bank(h, self.L)
        self.K = self._hp.shape[1]
        self._tail = np.zeros(0, np.float64)  # unconsumed input history
        self._tail_start = 0  # absolute index of _tail[0]
        self._n_in = 0  # absolute input samples received
        self._n_out = 0  # absolute output samples emitted

    def __call__(self, chunk: np.ndarray) -> np.ndarray:
        if self.identity:
            return np.asarray(chunk, np.float32)
        chunk = np.asarray(chunk, np.float64)
        self._tail = np.concatenate([self._tail, chunk])
        self._n_in += len(chunk)
        return self._emit(self._n_in - 1, None)

    def _emit(self, q_max_avail: int, n_cap: Optional[int]) -> np.ndarray:
        """Emit every output sample whose newest input tap (index q) is
        already available (q <= q_max_avail), up to index n_cap."""
        L, M, D, K = self.L, self.M, self.D, self.K
        # y[n] needs x[q], q = (n*M + D) // L  -> last n with q <= avail
        n_hi = ((q_max_avail + 1) * L - D - 1) // M  # max n : q <= avail
        if n_cap is not None:
            n_hi = min(n_hi, n_cap)
        if n_hi < self._n_out:
            return np.zeros(0, np.float32)
        n = np.arange(self._n_out, n_hi + 1)
        j = n * M + D
        p = j % L
        q = j // L
        idx = q[:, None] - np.arange(K)[None, :]
        rel = idx - self._tail_start
        valid = (idx >= 0) & (rel >= 0) & (rel < len(self._tail))
        xg = np.where(valid, self._tail[np.clip(
            rel, 0, max(len(self._tail) - 1, 0))], 0.0)
        y = np.einsum("nk,nk->n", xg, self._hp[p])
        self._n_out = n_hi + 1
        # drop input no longer reachable: future n >= n_out need
        # q - K + 1 >= (n_out*M + D)//L - K + 1
        keep_from = max((self._n_out * M + D) // L - K + 1, 0)
        if keep_from > self._tail_start:
            self._tail = self._tail[keep_from - self._tail_start:]
            self._tail_start = keep_from
        return y.astype(np.float32)

    def flush(self) -> np.ndarray:
        """Emit the zero-padded tail so total output length is
        ``ceil(n_in * L / M)``."""
        if self.identity:
            return np.zeros(0, np.float32)
        total = _out_len(self._n_in, self.L, self.M)
        if self._n_out >= total:
            return np.zeros(0, np.float32)
        # pretend enough zeros arrived to cover the last window
        need_q = ((total - 1) * self.M + self.D) // self.L
        pad = need_q - (self._n_in - 1)
        if pad > 0:
            self._tail = np.concatenate([self._tail, np.zeros(pad)])
        return self._emit(need_q, total - 1)
