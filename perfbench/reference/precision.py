"""The precisions the reference runs in, set for its own calls and put
back after: `float32` with TF32 off (what the configurations state, set
here rather than left to what the measured program set in the process),
and `tf32`, one precision below it, for the controls."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _tf32_switches(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def float32():
    """Float32 convolutions and matrix products, TF32 off."""
    return _tf32_switches(False)


def tf32():
    """TF32 convolutions and matrix products, as torch allows them."""
    return _tf32_switches(True)
