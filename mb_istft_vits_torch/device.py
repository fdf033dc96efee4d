"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU; there is no
silent fallback from one to the other.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, TypeVar, Union

import torch

T = TypeVar("T")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means CUDA. A CUDA device without a usable card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def disable_tf32() -> None:
    """Run float32 convolutions and matmuls in full float32 on the card.

    cuDNN convolutions default to TF32 (about three decimal digits), which
    would put the port's float32 outputs outside the tolerances it is held
    to against the JAX reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def device_constant(cache: Dict[tuple, T], key: tuple, like: torch.Tensor,
                    make: Callable[[], T]) -> T:
    """A constant of the computation (a window, filter taps) on like's
    device: `make()` once per (key, device), kept in `cache`. A CUDA graph
    capture must find it kept, as making it there would upload from the
    host or leave it unwritten outside the graph; the serving programs run
    eagerly before each capture. While `like` is traced (torch.export's
    tensors are subclasses) it is made afresh and not kept, so the traced
    program makes it itself."""
    if type(like) is not torch.Tensor:
        return make()
    full = (*key, like.device)
    hit = cache.get(full)
    if hit is None:
        if like.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"constant {full} was not made before this "
                               "CUDA graph capture")
        hit = cache[full] = make()
    return hit
