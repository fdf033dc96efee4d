"""Process groups, device meshes and data parallelism (counterpart of
`mb_istft_vits_tpu/parallel/mesh.py`; reference NCCL DDP,
train_latest.py:49-51,67,113-114).

The JAX package runs one program over a mesh of all chips, with the batch
sharded over its "data" axis, and several hosts through
`jax.distributed`: each process feeds its own rows of the global batch.
The port runs one process per card, as torchrun launches them, which is
JAX's multi-host layout with one chip per host: rank r takes batcher rank
r, the global batch is world x batch_size rows, and the gradient
all-reduce is DDP's. Serving fans a batch out over the devices of one
process instead (`infer/synthesis.py`): there `create_mesh` is a device
list and `shard_batch` splits rows over it.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist

from mb_istft_vits_torch.device import resolve_device

# a collective that waits longer than this fails the run instead of hanging
# it (an evaluation or a checkpoint on rank 0 takes seconds)
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class DistInfo(NamedTuple):
    """This process's place in the job: its rank, the world size and the
    device it runs on."""

    rank: int
    world: int
    device: torch.device


def init_distributed(address: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, *,
                     device: Union[str, torch.device, None] = "cuda",
                     backend: Optional[str] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT
                     ) -> DistInfo:
    """Start this process's group: from `address` ("tcp://host:port"),
    `world_size` and `rank` when given, else from torchrun's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). Without
    either there is no group, and the process runs alone on `device`.

    `device` "cuda" means card LOCAL_RANK (the rank when LOCAL_RANK is
    unset; a device with an index is taken as it is); the card becomes the current device before anything is
    allocated on it, so no rank opens a context on card 0. Fewer cards
    than local ranks raise. The backend is NCCL on CUDA and gloo on the
    CPU unless `backend` says otherwise (gloo when ranks share a card:
    NCCL refuses two ranks on one device). `timeout` bounds every
    collective."""
    if address is None and "WORLD_SIZE" not in os.environ:
        return DistInfo(0, 1, resolve_device(device))
    if address is None:
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"torchrun environment incomplete: {missing}")
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    else:
        if world_size is None or rank is None:
            raise ValueError("an explicit address needs world_size and rank")
        init_method = address
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        resolve_device(dev)  # no card: raises
        if dev.index is None:
            if local_rank >= torch.cuda.device_count():
                raise RuntimeError(
                    f"local rank {local_rank} needs card {local_rank}, and "
                    f"there are {torch.cuda.device_count()} cards")
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    # NCCL binds the rank to its card at once, so a bad layout fails here
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout,
                            device_id=dev if backend == "nccl" else None)
    return DistInfo(rank, world_size, dev)


def create_mesh(num_devices: Optional[int] = None, axis_name: str = "data",
                *, device_type: str = "cuda"):
    """The first `num_devices` devices (all of them by default). In a
    process group: a 1-D `DeviceMesh` whose one dimension is `axis_name`,
    over the group's ranks, one device each. Without one: a list of this
    process's devices, the serving mesh, whose one axis needs no name
    (`device_type` "cpu" gives that many CPU devices, as JAX tests force
    host devices). Fewer devices than asked raise."""
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        world = dist.get_world_size()
        n = world if num_devices is None else num_devices
        if n != world:
            raise ValueError(f"a data mesh of {n} devices in a process group "
                             f"of {world} ranks")
        return init_device_mesh(device_type, (n,),
                                mesh_dim_names=(axis_name,))
    if device_type == "cpu":
        return [torch.device("cpu")] * (num_devices or 1)
    have = torch.cuda.device_count()
    n = have if num_devices is None else num_devices
    if n < 1 or n > have:
        raise ValueError(f"a mesh of {n} cards, and there are {have}")
    return [torch.device("cuda", i) for i in range(n)]


def mesh_devices(mesh) -> List[torch.device]:
    """The devices of a serving mesh: a sequence of devices (or names);
    None is no mesh."""
    if mesh is None:
        return []
    if hasattr(mesh, "mesh_dim_names"):
        raise TypeError("a DeviceMesh spans processes; a serving mesh is a "
                        "list of this process's devices (create_mesh "
                        "without a process group)")
    return [torch.device(d) for d in mesh]


def mesh_size(mesh) -> int:
    """Devices in `mesh`: None is one; else its `size` (an int, or a method
    as on `DeviceMesh`), or its length (a device list)."""
    if mesh is None:
        return 1
    size = getattr(mesh, "size", None)
    if callable(size):
        size = size()
    return int(len(mesh) if size is None else size)


def shard_batch(batch: Any, mesh: Sequence, axis_name: str = "data"
                ) -> List[Any]:
    """Split each tensor's leading dim into equal parts over the serving
    mesh's devices: part i (rows [i * B/n:(i + 1) * B/n]) goes to device
    i, without blocking. Dicts, lists and tuples are walked; None passes
    through. `axis_name` is JAX's: a serving mesh has one axis, the one
    the batch is split over, whatever its name."""
    devices = mesh_devices(mesh)
    n = len(devices)

    def part(x, i):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: part(v, i) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(part(v, i) for v in x)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split over {n} "
                             f"devices")
        rows = x.shape[0] // n
        return x[i * rows:(i + 1) * rows].to(devices[i], non_blocking=True)

    return [part(batch, i) for i in range(n)]


def data_parallel(module: torch.nn.Module) -> torch.nn.Module:
    """`module` under DDP when a process group is running (its forward then
    arms the gradient all-reduce of the backward), else `module` itself.
    Buffers are not broadcast: they are constant windows and filters, and
    broadcasting them would add a collective to every forward."""
    if not dist.is_initialized():
        return module
    dev = next(module.parameters()).device
    return torch.nn.parallel.DistributedDataParallel(
        module, device_ids=[dev] if dev.type == "cuda" else None,
        broadcast_buffers=False)


def shard_train_state_dp(state):
    """Make `state` (`train.step.TrainState`) data-parallel over the process
    group: its forwards go through DDP wrappers of the generator and the
    discriminator, which stay the plain modules in `net_g` / `net_d` (for
    evaluation and checkpoints, and for D inside the G step), and its data
    rank and replicas are the group's. Without a group it is left as it
    is. Returns `state`."""
    if not dist.is_initialized():
        return state
    state.ddp_g = data_parallel(state.net_g)
    state.ddp_d = data_parallel(state.net_d)
    state.data_rank, state.data_world = dist.get_rank(), dist.get_world_size()
    return state
