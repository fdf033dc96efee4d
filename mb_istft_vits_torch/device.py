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


def mesh_size(mesh) -> int:
    """Devices in `mesh`: None is one; else its `size` (an int, or a method
    as on `torch.distributed.DeviceMesh`), or its length (a device list)."""
    if mesh is None:
        return 1
    size = getattr(mesh, "size", None)
    if callable(size):
        size = size()
    return int(len(mesh) if size is None else size)


def require_one_device(mesh, what: str) -> None:
    """A mesh of one device (or None) runs as no mesh, by the JAX
    package's `mesh.size > 1` rule; a larger one raises."""
    if mesh_size(mesh) > 1:
        raise NotImplementedError(
            f"{what}: a mesh of {mesh_size(mesh)} devices is not ported yet "
            "(ROADMAP Queue 1 item 9.3: DDP and the serving mesh); pass "
            "mesh=None")
