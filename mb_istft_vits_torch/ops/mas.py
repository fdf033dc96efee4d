"""Monotonic Alignment Search (MAS): the plain PyTorch version and the
wrappers of the CUDA kernels in `csrc/mas.cu` (counterpart of
`mb_istft_vits_tpu/ops/mas.py` and `ops/mas_pallas.py`).

neg_cent, mask: [B, T_y, T_x] (y = spectrogram frames, x = text tokens);
the result is a 0/1 alignment path of the same shape. The DP runs in
float32 whatever the input dtype; lengths come from the mask sums.

`maximum_path` dispatches by device: a CUDA tensor launches the kernels
(or raises), a CPU tensor takes the plain version. The plain version is a
row wavefront plus a backtrack loop, vectorized over the batch; the tests
and `chip_smoke.py` hold the kernels against it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Tuple, Union

import torch

from mb_istft_vits_torch import kernels

_MAX_NEG = -1e9

# Launches of each kernel in this process. Each wrapper adds one where it
# launches its kernel, and nowhere else: `mas_backtrack` launches two,
# mas_bwd_kernel ("mas_bwd") and mas_path_kernel ("mas_path"). A wrapper
# called while a CUDA graph is captured launches nothing then, and every
# replay of the graph launches its kernels again: `captured_launches` and
# `add_launches` move its counts from the capture to the replays.
launch_counts = {"mas_fused": 0, "mas_fwd": 0, "mas_bwd": 0, "mas_path": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


@contextlib.contextmanager
def captured_launches() -> Iterator[Dict[str, int]]:
    """Around a CUDA graph's capture: yields a dict that holds, once the
    block is left, what the wrappers counted inside it, and takes those
    counts back out of `launch_counts` (a capture launches nothing). Each
    replay of the graph then adds them (`add_launches`), so the counts
    stay kernels launched."""
    before = dict(launch_counts)
    diff: Dict[str, int] = {}
    try:
        yield diff
    finally:
        for name, n in before.items():
            diff[name] = launch_counts[name] - n
            launch_counts[name] = n


def add_launches(diff: Dict[str, int]) -> None:
    """A replay's launches: the counts its capture recorded."""
    for name, n in diff.items():
        launch_counts[name] += n


def mas_lengths(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t_ys, t_xs) int32 [B] from a [B, T_y, T_x] mask."""
    t_ys = mask[:, :, 0].sum(dim=1).to(torch.int32)
    t_xs = mask[:, 0, :].sum(dim=1).to(torch.int32)
    return t_ys, t_xs


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def mas_decisions_plain(nc: torch.Tensor, t_ys: torch.Tensor,
                        t_xs: torch.Tensor) -> torch.Tensor:
    """DP forward: nc f32 [B, T_y, T_x] (neg_cent * mask) -> decisions
    bool [B, T_y, T_x]; True moves the backtrack one token left."""
    b, t_y_max, t_x_max = nc.shape
    xs = torch.arange(t_x_max, device=nc.device)[None, :]
    t_ys, t_xs = t_ys.long()[:, None], t_xs.long()[:, None]
    prev = torch.full((b, t_x_max), _MAX_NEG, dtype=torch.float32,
                      device=nc.device)
    dec = torch.empty((b, t_y_max, t_x_max), dtype=torch.bool,
                      device=nc.device)
    for y in range(t_y_max):
        first = torch.full((b, 1), 0.0 if y == 0 else _MAX_NEG,
                           dtype=torch.float32, device=nc.device)
        shifted = torch.cat([first, prev[:, :-1]], dim=1)
        v_cur = torch.where(xs == y, _MAX_NEG, prev)
        dec[:, y] = (xs == y) | (v_cur < shifted)
        row = nc[:, y] + torch.maximum(shifted, v_cur)
        lo = torch.clamp(t_xs + y - t_ys, min=0)
        hi = torch.clamp(t_xs, max=y + 1)
        prev = torch.where((xs >= lo) & (xs < hi), row, _MAX_NEG)
    return dec


def mas_backtrack_plain(dec: torch.Tensor, t_ys: torch.Tensor,
                        t_xs: torch.Tensor) -> torch.Tensor:
    """Backtrack: decisions bool [B, T_y, T_x] -> path f32 [B, T_y, T_x]."""
    b, t_y_max, t_x_max = dec.shape
    rows = torch.arange(b, device=dec.device)
    t_ys = t_ys.long()
    index = t_xs.long() - 1
    path = torch.zeros(dec.shape, dtype=torch.float32, device=dec.device)
    for y in range(t_y_max - 1, -1, -1):
        active = (y < t_ys) & (index >= 0)
        safe = index.clamp(min=0)
        path[rows, y, safe] = active.float()
        move = active & dec[rows, y, safe] & (index > 0)
        index = index - move.long()
    return path


def maximum_path_plain(neg_cent: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    nc = neg_cent.float() * mask
    t_ys, t_xs = mas_lengths(mask)
    path = mas_backtrack_plain(mas_decisions_plain(nc, t_ys, t_xs), t_ys, t_xs)
    return path.to(neg_cent.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_inputs(nc: torch.Tensor, t_ys: torch.Tensor,
                  t_xs: torch.Tensor) -> Tuple[int, int, int]:
    if not nc.is_cuda:
        raise ValueError("the MAS kernels take CUDA tensors; got "
                         f"{nc.device} (use the plain version on the CPU)")
    if nc.dtype != torch.float32 or nc.dim() != 3 or not nc.is_contiguous():
        raise ValueError("neg_cent must be a contiguous float32 "
                         f"[B, T_y, T_x] tensor; got {nc.dtype} "
                         f"{tuple(nc.shape)}")
    b, t_y, t_x = nc.shape
    for t in (t_ys, t_xs):
        if (t.dtype != torch.int32 or t.shape != (b,)
                or t.device != nc.device or not t.is_contiguous()):
            raise ValueError("lengths must be contiguous int32 [B] tensors "
                             "on the same device as neg_cent")
    if t_x > kernels.library().mas_max_columns():
        raise ValueError(f"T_x={t_x} exceeds the kernels' column limit")
    return b, t_y, t_x


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def mas_fused(nc: torch.Tensor, t_ys: torch.Tensor,
              t_xs: torch.Tensor) -> torch.Tensor:
    """Fused DP forward + backtrack (replaces `_fused_kernel`): nc f32
    [B, T_y, T_x] on CUDA -> path f32 [B, T_y, T_x]."""
    b, t_y, t_x = _check_inputs(nc, t_ys, t_xs)
    path = torch.empty_like(nc)
    if path.numel() == 0:
        return path
    with torch.cuda.device(nc.device):
        code = kernels.library().mas_fused(
            nc.data_ptr(), t_ys.data_ptr(), t_xs.data_ptr(), path.data_ptr(),
            b, t_y, t_x, _stream(nc))
    kernels.check(code, "mas_fused")
    launch_counts["mas_fused"] += 1
    return path


def mas_forward_bits(nc: torch.Tensor, t_ys: torch.Tensor,
                     t_xs: torch.Tensor) -> torch.Tensor:
    """DP forward (replaces `_fwd_kernel`): nc f32 [B, T_y, T_x] on CUDA ->
    decision bits int32 [B, T_y, ceil(T_x / 32)] (bit x % 32 of word x // 32;
    rows y >= t_y are left unwritten)."""
    b, t_y, t_x = _check_inputs(nc, t_ys, t_xs)
    dec = torch.empty((b, t_y, (t_x + 31) // 32), dtype=torch.int32,
                      device=nc.device)
    if nc.numel() == 0:
        return dec
    with torch.cuda.device(nc.device):
        code = kernels.library().mas_fwd(
            nc.data_ptr(), t_ys.data_ptr(), t_xs.data_ptr(), dec.data_ptr(),
            b, t_y, t_x, _stream(nc))
    kernels.check(code, "mas_fwd")
    launch_counts["mas_fwd"] += 1
    return dec


def mas_backtrack(dec: torch.Tensor, t_ys: torch.Tensor, t_xs: torch.Tensor,
                  t_x_max: int) -> torch.Tensor:
    """Backtrack (replaces `_bwd_kernel`): decision bits from
    `mas_forward_bits` -> path f32 [B, T_y, t_x_max]. Two kernels: the
    backtrack writes each row's cursor to an int32 [B, T_y] scratch, and
    the path writer, started behind it, writes every path cell."""
    if not dec.is_cuda:
        raise ValueError(f"the MAS kernels take CUDA tensors; got {dec.device}")
    b, t_y, words = dec.shape
    if (dec.dtype != torch.int32 or not dec.is_contiguous()
            or words != (t_x_max + 31) // 32):
        raise ValueError("dec must be contiguous int32 [B, T_y, ceil(T_x/32)]")
    path = torch.empty((b, t_y, t_x_max), dtype=torch.float32,
                       device=dec.device)
    _check_inputs(path, t_ys, t_xs)
    if path.numel() == 0:
        return path
    cursor = torch.empty((b, t_y), dtype=torch.int32, device=dec.device)
    with torch.cuda.device(dec.device):
        code = kernels.library().mas_bwd(
            dec.data_ptr(), t_ys.data_ptr(), t_xs.data_ptr(),
            cursor.data_ptr(), path.data_ptr(), b, t_y, t_x_max, _stream(dec))
    kernels.check(code, "mas_bwd")
    launch_counts["mas_bwd"] += 1
    launch_counts["mas_path"] += 1
    return path


def fused_fits(t_y: int, t_x: int, device: torch.device) -> bool:
    """Whether the fused kernel's shared memory (the DP's neg_cent ring,
    decision bits, path cursors) fits one block of `device`."""
    lib = kernels.library()
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return lib.mas_fused_shared_bytes(t_y, t_x) <= \
        lib.mas_max_shared_bytes(index)


def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor,
                 use_pallas: Union[str, bool] = "auto", *,
                 force: str = "auto") -> torch.Tensor:
    """Hard monotonic alignment (reference `monotonic_align.maximum_path`).

    use_pallas is the JAX package's third slot, whose True picks its
    Pallas kernels: here True launches the CUDA kernels that port them (a
    CPU tensor raises: they need the card), False runs the plain version,
    and "auto" launches the kernels for a CUDA tensor and runs the plain
    version for a CPU one. force: "auto" picks the fused kernel when its
    shared memory fits one block and the two-pass pair otherwise; "fused"
    and "two_pass" pin one, as `maximum_path_pallas(force=...)` does.

    The kernels read neg_cent only inside each item's band, where the
    [B, T_y, T_x] product mask is 1, so they skip the `neg_cent * mask`
    that the plain version computes: the result is the same.
    """
    if use_pallas not in ("auto", True, False):
        raise ValueError("use_pallas must be 'auto', True or False, got "
                         f"{use_pallas!r}")
    if force not in ("auto", "fused", "two_pass"):
        raise ValueError(f"force must be auto|fused|two_pass, got {force!r}")
    if use_pallas == "auto":
        use_pallas = neg_cent.is_cuda
    if not use_pallas:
        return maximum_path_plain(neg_cent, mask)
    if not neg_cent.is_cuda:
        raise ValueError("use_pallas=True launches the CUDA kernels, which "
                         f"take CUDA tensors; got {neg_cent.device}")
    nc = neg_cent.float().contiguous()
    t_ys, t_xs = mas_lengths(mask)
    _, t_y, t_x = nc.shape
    if force == "auto":
        force = "fused" if fused_fits(t_y, t_x, nc.device) else "two_pass"
    if force == "fused":
        path = mas_fused(nc, t_ys, t_xs)
    else:
        path = mas_backtrack(mas_forward_bits(nc, t_ys, t_xs), t_ys, t_xs, t_x)
    return path.to(neg_cent.dtype)


# ---------------------------------------------------------------------------
# decision-bit packing (for comparing the two-pass kernels with the plain
# version)
# ---------------------------------------------------------------------------


def pack_decisions(dec: torch.Tensor) -> torch.Tensor:
    """bool [B, T_y, T_x] -> int32 [B, T_y, ceil(T_x / 32)] in the layout
    of `mas_forward_bits`."""
    b, t_y, t_x = dec.shape
    words = (t_x + 31) // 32
    padded = torch.zeros((b, t_y, words * 32), dtype=torch.int64,
                         device=dec.device)
    padded[..., :t_x] = dec.long()
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=dec.device),
        torch.arange(32, device=dec.device))
    packed = (padded.view(b, t_y, words, 32) * weights).sum(-1)
    packed = torch.where(packed >= 2**31, packed - 2**32, packed)
    return packed.to(torch.int32)


def unpack_decisions(bits: torch.Tensor, t_x: int) -> torch.Tensor:
    """Inverse of `pack_decisions`."""
    b, t_y, words = bits.shape
    shifts = torch.arange(32, device=bits.device)
    unpacked = (bits.long()[..., None] >> shifts) & 1
    return unpacked.view(b, t_y, words * 32)[..., :t_x].bool()
