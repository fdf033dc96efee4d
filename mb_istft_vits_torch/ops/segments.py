"""Segment slicing, sinusoid timing signals and duration -> alignment path
expansion (counterpart of `mb_istft_vits_tpu/ops/segments.py`; reference
`commons.py:48-143`). Sequence tensors are [B, C, T]; paths are
[B, T_y, T_x]."""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] -> [B, T] bool (reference commons.py:121-125)."""
    pos = torch.arange(max_length, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def slice_segments(x: torch.Tensor, ids_str: torch.Tensor,
                   segment_size: int) -> torch.Tensor:
    """x [B, C, T], ids_str [B] -> [B, C, segment_size]. Starts are clamped
    so the window fits, as `lax.dynamic_slice` clamps in the JAX package."""
    b, c, t = x.shape
    start = ids_str.long().clamp(0, max(t - segment_size, 0))
    idx = start[:, None] + torch.arange(segment_size, device=x.device)
    return x.gather(2, idx[:, None, :].expand(b, c, segment_size))


def rand_slice_segments(
    x: torch.Tensor,
    rng: Union[None, int, torch.Generator] = None,
    x_lengths: Optional[torch.Tensor] = None,
    segment_size: int = 4,
    *,
    ids_str: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random windowed slice for the vocoder tail (reference
    commons.py:57-64). `rng` is JAX's key slot in torch's terms: a
    `torch.Generator`, an int seed, or None for torch's global generator.
    `ids_str` may be given instead of drawn. Returns (segments
    [B, C, segment_size], start ids [B])."""
    b, _, t = x.shape
    if ids_str is None:
        if x_lengths is None:
            x_lengths = torch.full((b,), t, device=x.device)
        if isinstance(rng, int):
            rng = torch.Generator(x.device).manual_seed(rng)
        ids_str_max = torch.clamp(x_lengths - segment_size + 1, min=1)
        u = torch.rand(b, generator=rng, device=x.device)
        ids_str = (u * ids_str_max).to(torch.int32)
    return slice_segments(x, ids_str, segment_size), ids_str


def get_timing_signal_1d(length: int, channels: int,
                         min_timescale: float = 1.0,
                         max_timescale: float = 1.0e4, *,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """Transformer sinusoid position signal [1, channels, length]: sines of
    channels // 2 geometric timescales, then their cosines, and one zero
    channel when `channels` is odd (reference commons.py:67-82). The port's
    [B, C, T] layout, as the reference's; the JAX package returns
    [1, length, channels]. Computed on `device` (the CPU by default)."""
    position = torch.arange(length, dtype=torch.float32, device=device)
    num_timescales = channels // 2
    log_timescale_increment = (math.log(max_timescale / min_timescale)
                               / max(num_timescales - 1, 1))
    inv_timescales = min_timescale * torch.exp(
        torch.arange(num_timescales, dtype=torch.float32, device=device)
        * -log_timescale_increment)
    scaled_time = inv_timescales[:, None] * position[None, :]  # [C/2, T]
    signal = torch.cat([torch.sin(scaled_time), torch.cos(scaled_time)], 0)
    return F.pad(signal, (0, 0, 0, channels % 2))[None]


def add_timing_signal_1d(x: torch.Tensor, min_timescale: float = 1.0,
                         max_timescale: float = 1.0e4) -> torch.Tensor:
    """x [B, C, T] plus the sinusoid signal (reference commons.py:85-88)."""
    _, c, t = x.shape
    return x + get_timing_signal_1d(t, c, min_timescale, max_timescale,
                                    device=x.device).to(x.dtype)


def cat_timing_signal_1d(x: torch.Tensor, min_timescale: float = 1.0,
                         max_timescale: float = 1.0e4,
                         axis: int = 1) -> torch.Tensor:
    """x [B, C, T] and the sinusoid signal, broadcast over the batch,
    concatenated on `axis` (reference commons.py:91-94): the channel axis,
    1, by default (JAX's default, -1, is its channel axis)."""
    b, c, t = x.shape
    signal = get_timing_signal_1d(t, c, min_timescale, max_timescale,
                                  device=x.device).to(x.dtype)
    return torch.cat([x, signal.expand(b, c, t)], axis)


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Expand integer-valued durations [B, T_x] into a hard monotonic
    alignment [B, T_y, T_x] under mask [B, T_y, T_x]
    (reference commons.py:128-143)."""
    t_y = mask.shape[1]
    cum = torch.cumsum(duration, dim=-1)  # [B, T_x]
    steps = torch.arange(t_y, device=duration.device)
    path = (steps[None, None, :] < cum[:, :, None]).to(mask.dtype)  # [B,Tx,Ty]
    path = path - torch.nn.functional.pad(path, (0, 0, 1, 0))[:, :-1]
    return path.transpose(1, 2) * mask
