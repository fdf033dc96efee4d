"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU; there is no
silent fallback from one to the other.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


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
