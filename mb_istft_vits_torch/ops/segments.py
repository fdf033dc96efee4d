"""Segment slicing and duration -> alignment path expansion (counterpart of
`mb_istft_vits_tpu/ops/segments.py`; reference `commons.py:48-64,
121-143`). Sequence tensors are [B, C, T]; paths are [B, T_y, T_x]."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


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
    x_lengths: Optional[torch.Tensor] = None,
    segment_size: int = 4,
    generator: Optional[torch.Generator] = None,
    ids_str: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random windowed slice for the vocoder tail (reference
    commons.py:57-64). `ids_str` may be given instead of drawn from
    `generator`. Returns (segments [B, C, segment_size], start ids [B])."""
    b, _, t = x.shape
    if ids_str is None:
        if x_lengths is None:
            x_lengths = torch.full((b,), t, device=x.device)
        ids_str_max = torch.clamp(x_lengths - segment_size + 1, min=1)
        u = torch.rand(b, generator=generator, device=x.device)
        ids_str = (u * ids_str_max).to(torch.int32)
    return slice_segments(x, ids_str, segment_size), ids_str


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
