"""Parameters and AdamW moments sharded over a 2-D (data x model) mesh
(counterpart of `mb_istft_vits_tpu/parallel/tp.py`).

The JAX package gives every parameter leaf a sharding that splits one of
its dimensions over the mesh's "model" axis (its rule: the trailing,
output-channel dimension when the axis size divides it, else an earlier
one, else replicate; 1-D leaves replicate), keeps the batch sharded over
"data", and lets XLA partition the convolutions. Its AdamW moments take
their parameter's sharding.

The port puts both nets under FSDP2 (`fully_shard`) over the same mesh:
replicated over "data" and sharded over "model" by the same rule, moved
into torch's layout (`param_spec`: flax's trailing output dimension is
dim 0 of a torch [out, in, k] convolution weight). The leaves the rule
replicates are left to the step, which averages their gradients itself
(`train.step`). The optimizers are rebuilt on the sharded parameters, so
their moments are DTensors of the same placement (JAX
`opt_state_shardings`). Every "model" rank of one data replica takes the
same rows and draws, as the JAX batch is replicated across "model"; their
identical gradients average to themselves, so the numbers are the
single-process step's.

One difference is kept: XLA partitions each convolution over "model",
while FSDP2 all-gathers a layer's weights and computes it whole on every
"model" rank. The state's memory and the numbers are JAX's; the split of
the compute is not (ROADMAP, "Known differences").
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mb_istft_vits_torch.nn.layers import Conv1d, Conv2d, ConvTranspose1d


def mesh_shape(n_model: int, n_data: Optional[int], n_devices: int
               ) -> Tuple[int, int]:
    """(n_data, n_model) of a (data, model) mesh over `n_devices`, with
    JAX's tiling errors: a derived data axis must tile the devices
    exactly; an explicit one may use a subset."""
    if n_data is None:
        n_data = n_devices // n_model
        if n_data < 1 or n_data * n_model != n_devices:
            raise ValueError(
                f"n_model={n_model} does not tile the {n_devices} "
                f"available devices; pass n_data explicitly to use a "
                f"subset")
    elif n_data * n_model > n_devices:
        raise ValueError(
            f"data x model = {n_data} x {n_model} needs "
            f"{n_data * n_model} devices, have {n_devices}")
    return n_data, n_model


def create_2d_mesh(n_model: int, n_data: Optional[int] = None,
                   devices: Optional[Sequence[int]] = None, *,
                   device_type: Optional[str] = None):
    """`DeviceMesh` of shape (data, model) over the process group's ranks
    (`devices`: the ranks to use, all of them by default), "model"
    innermost, so the model shards of one data replica are consecutive
    ranks (`mesh_shape` checks the tiling). Every rank must call this.
    `device_type` defaults to "cuda" when a card is present."""
    from torch.distributed.device_mesh import DeviceMesh

    if devices is None:
        devices = list(range(dist.get_world_size()))
    n_data, n_model = mesh_shape(n_model, n_data, len(devices))
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    ranks = torch.tensor(list(devices)[:n_data * n_model]).reshape(
        n_data, n_model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def param_spec(shape, axis_size: int,
               dims: Optional[Sequence[int]] = None) -> Optional[int]:
    """The dimension of a leaf to shard over an axis of `axis_size`, or
    None to replicate it: the first of `dims` that the axis divides (JAX's
    order: the trailing dimension first when `dims` is not given). 1-D
    leaves replicate: they are negligible, and sharding them would reshard
    every elementwise add."""
    if len(shape) < 2:
        return None
    for d in (range(len(shape) - 1, -1, -1) if dims is None else dims):
        if shape[d] % axis_size == 0 and shape[d] >= axis_size:
            return d
    return None


def torch_dims(module: torch.nn.Module, ndim: int) -> Tuple[int, ...]:
    """JAX's order of a leaf's dimensions, trailing first in flax's layout,
    as dimensions of the torch leaf that `module` holds: a convolution
    [out, in, k..] is flax's [k.., in, out], a transposed one [in, out, k]
    is [k, in, out], an embedding is the same in both."""
    if ndim >= 2 and isinstance(module, (Conv1d, Conv2d, torch.nn.Linear)):
        return (0, 1) + tuple(range(ndim - 1, 1, -1))
    if ndim >= 2 and isinstance(module, ConvTranspose1d):
        return (1, 0) + tuple(range(ndim - 1, 1, -1))
    return tuple(range(ndim - 1, -1, -1))


def param_shardings(net: torch.nn.Module, axis_size: int
                    ) -> Dict[str, Optional[int]]:
    """{parameter name: the dimension sharded over "model", or None}."""
    out = {}
    for mname, module in net.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            out[name] = param_spec(p.shape, axis_size,
                                   torch_dims(module, p.ndim))
    return out


def shard_train_state_tp(state, mesh, axis_name: str = "model"):
    """Put `state` (`train.step.TrainState`, its nets on this rank's
    device) under FSDP2 over the (data, model) `mesh`: each parameter
    sharded over `axis_name` by `param_shardings`, or replicated; both
    AdamW optimizers rebuilt on the sharded parameters (fresh moments,
    which the first step makes DTensors of their parameter's placement).
    The state takes the mesh's data rank and replicas. Returns `state`."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from mb_istft_vits_torch.train.step import make_optimizer

    axis_size = mesh[axis_name].size()
    for net in (state.net_g, state.net_d):
        dims = param_shardings(net, axis_size)
        params = dict(net.named_parameters())
        placement = {params[k]: Shard(d) for k, d in dims.items()
                     if d is not None}
        fully_shard(net, mesh=mesh, shard_placement_fn=placement.get,
                    ignored_params={params[k] for k, d in dims.items()
                                    if d is None})
    state.optim_g = make_optimizer(state.net_g.parameters(), state.cfg.train)
    state.optim_d = make_optimizer(state.net_d.parameters(), state.cfg.train)
    for optim in (state.optim_g, state.optim_d):
        for group in optim.param_groups:
            # sharded and replicated parameters do not mix in one foreach op
            group["foreach"] = False
    state.tp_mesh = mesh
    state.data_rank = mesh.get_local_rank("data")
    state.data_world = mesh["data"].size()
    return state


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A parameter, gradient or moment of `shard_train_state_tp` whole: a
    DTensor's shards all-gathered over its mesh's "model" ranks and joined
    on the sharded dimension (a plain tensor as it is). A collective on
    every "model" rank. It takes c10d's all-gather, as FSDP2 does:
    `DTensor.full_tensor()` takes the functional collectives, which
    crash under gloo on CUDA tensors (two ranks sharing a card)."""
    if not hasattr(t, "to_local"):
        return t
    local = t.to_local().contiguous()
    dims = [p.dim for p in t.placements if p.is_shard()]
    if not dims:
        return local
    group = t.device_mesh.get_group("model")
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim=dims[0])


def global_norm(grads) -> torch.Tensor:
    """The L2 norm of all of `grads`, DTensor shards included: each
    shard's sum of squares, summed over the "model" ranks (the data
    replicas hold the same gradients)."""
    sharded = [g for g in grads if hasattr(g, "to_local")]
    sq = torch.stack([g.to_local().float().pow(2).sum() for g in sharded]
                     ).sum()
    dist.all_reduce(sq, group=sharded[0].device_mesh.get_group("model"))
    plain = [g.float().pow(2).sum() for g in grads
             if not hasattr(g, "to_local")]
    return torch.sqrt(sq + (torch.stack(plain).sum() if plain else 0.0))


def full_state_dicts(net: torch.nn.Module, optim: torch.optim.Optimizer
                     ) -> Tuple[dict, dict]:
    """The whole (unsharded) state dicts of a sharded `net` and of its
    optimizer, on the CPU, in the layout of `net.state_dict()` and
    `optim.state_dict()` (parameters by index), so a reference loader reads
    them. A collective: every rank calls it."""
    def whole(t):
        return full_tensor(t).detach().cpu() if torch.is_tensor(t) else t

    model = {k: whole(v) for k, v in net.state_dict().items()}
    optim_sd = optim.state_dict()
    state = {i: {k: whole(v) for k, v in s.items()}
             for i, s in optim_sd["state"].items()}
    return model, {"state": state, "param_groups": optim_sd["param_groups"]}
