"""Parameters and AdamW moments sharded over a 2-D (data x model) mesh
(counterpart of `mb_istft_vits_tpu/parallel/tp.py`).

The JAX package gives every parameter leaf a sharding that splits one of
its dimensions over the mesh's "model" axis (its rule: the trailing,
output-channel dimension when the axis size divides it, else an earlier
one, else replicate; 1-D leaves replicate), keeps the batch sharded over
"data", and lets XLA partition the convolutions. Its AdamW moments take
their parameter's sharding.

The port holds the shards itself (`NetShards`), by the same rule moved
into torch's layout (`param_spec`: flax's trailing output dimension is
dim 0 of a torch [out, in, k] convolution weight). Each rank keeps its
"model" slice of every sharded leaf as a view of one flat send buffer a
net; the optimizers are rebuilt over those shards and the replicated
leaves, so the moments are shard-shaped (JAX `opt_state_shardings`) and
AdamW is capturable as on one card. The modules keep their whole
parameters, at the same addresses for the life of the state, so
evaluation, checkpoints and serving read them between steps as they
always have. Every "model" rank of one data replica takes the same rows
and draws, as the JAX batch is replicated across "model", so each
computes the same whole gradients; the step (`train.step`) averages them
over every rank, updates this rank's shards, all-gathers them over
"model" into one receive buffer a net and copies that into the whole
parameters in place.

One difference is kept: XLA partitions each convolution over "model",
while the port computes each layer whole on every "model" rank, and so
keeps the whole parameters resident (the moments, twice the parameters,
stay sharded). The state's numbers are JAX's; the split of the compute
and of the parameters' memory is not (ROADMAP, "Known differences").
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

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


def param_spec(shape, axis_size: int, axis_name: str = "model", *,
               dims: Optional[Sequence[int]] = None) -> Optional[int]:
    """The dimension of a leaf to shard over the mesh axis `axis_name` of
    `axis_size` devices, or None to replicate it: the first of `dims` that
    the axis divides (JAX's order: the trailing dimension first when
    `dims` is not given). JAX returns the `PartitionSpec` that names
    `axis_name` at this dimension. 1-D leaves replicate: they are
    negligible, and sharding them would reshard every elementwise add."""
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


def param_shardings(net: torch.nn.Module, mesh, axis_name: str = "model"
                    ) -> Dict[str, Optional[int]]:
    """{parameter name of `net`: the dimension sharded over the mesh axis
    `axis_name`, or None}. `mesh` is a `DeviceMesh` or that axis's size."""
    axis_size = mesh if isinstance(mesh, int) else mesh[axis_name].size()
    out = {}
    for mname, module in net.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            out[name] = param_spec(p.shape, axis_size, axis_name,
                                   dims=torch_dims(module, p.ndim))
    return out


class NetShards:
    """This rank's shards of one net over the mesh axis of `size` ranks
    (`group`, this rank `rank` in it): the leaves `dims` names ({name: the
    sharded dimension, or None}), each sliced along its dimension, as
    views of one flat float32 send buffer, in the net's parameter order;
    and a receive buffer of `size` times its length for the group's
    all-gather. Both buffers are made once, here, outside any graph pool,
    and filled from the net's whole parameters."""

    def __init__(self, net: torch.nn.Module, dims: Dict[str, Optional[int]],
                 group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size
        params = list(net.named_parameters())
        # (position in net.parameters(), parameter, dimension)
        self.leaves = [(i, p, dims[name]) for i, (name, p) in
                       enumerate(params) if dims.get(name) is not None]
        counts = [p.numel() // size for _, p, _ in self.leaves]
        dev = params[0][1].device
        self.send = torch.zeros(sum(counts), dtype=torch.float32, device=dev)
        self.recv = torch.zeros(size * sum(counts), dtype=torch.float32,
                                device=dev)
        self.shards = [piece.view(self._shard_shape(p, d)) for piece,
                       (_, p, d) in zip(self.send.split(counts), self.leaves)]
        self._of = {id(p): s for (_, p, _), s in zip(self.leaves,
                                                     self.shards)}
        # the whole parameters' slices and the receive buffer's pieces
        self._whole, self._received = [], []
        for j, chunk in enumerate(self.recv.chunk(size)):
            for (_, p, d), piece, shard in zip(
                    self.leaves, chunk.split(counts), self.shards):
                self._whole.append(p.detach().narrow(
                    d, j * shard.shape[d], shard.shape[d]))
                self._received.append(piece.view(shard.shape))
        self.refresh()

    def _shard_shape(self, p, d) -> List[int]:
        shape = list(p.shape)
        shape[d] //= self.size
        return shape

    def _own(self, t: torch.Tensor, d: int) -> torch.Tensor:
        """This rank's slice of a whole leaf-shaped tensor along `d`."""
        k = t.shape[d] // self.size
        return t.narrow(d, self.rank * k, k)

    def optimizer_params(self, net: torch.nn.Module) -> List[torch.Tensor]:
        """What the net's AdamW updates: its parameters in order, each
        sharded one replaced by this rank's shard."""
        return [self._of.get(id(p), p) for p in net.parameters()]

    def refresh(self) -> None:
        """Every shard written from its whole parameter, in place (after
        the whole parameters were loaded)."""
        with torch.no_grad():
            torch._foreach_copy_(self.shards, [
                self._own(p.detach(), d) for _, p, d in self.leaves])

    def take_grads(self) -> None:
        """Each shard's gradient from its whole parameter's (reduced)
        gradient: along dim 0 a view of it, made at the first call;
        along another dim a tensor of the shard's shape, made at the
        first call and written in place at every later one. A leaf
        without a gradient leaves its shard without one (AdamW skips
        it)."""
        dst, src = [], []
        for (_, p, d), shard in zip(self.leaves, self.shards):
            if p.grad is None:
                continue
            part = self._own(p.grad, d)
            if shard.grad is None:
                shard.grad = part if d == 0 else part.contiguous()
            elif d:
                dst.append(shard.grad)
                src.append(part)
        if dst:
            torch._foreach_copy_(dst, src)

    def gather(self) -> None:
        """The group's all-gather of the send buffers into the receive
        buffer, rank by rank, on the current stream, as c10d's list of
        outputs (the receive buffer's chunks): one form for gloo and NCCL
        (the functional collectives crash under gloo on CUDA tensors)."""
        dist.all_gather(list(self.recv.chunk(self.size)), self.send,
                        group=self.group)

    def put_whole(self) -> None:
        """The whole parameters written from the receive buffer, in
        place."""
        with torch.no_grad():
            torch._foreach_copy_(self._whole, self._received)

    def whole_optimizer_state(self, optim_sd: dict) -> dict:
        """`optim_sd` (an AdamW state dict of `optimizer_params`, by
        index) with each shard's moments gathered whole over the group
        and joined on its dimension: the state dict of the whole net's
        AdamW. A collective on every rank of the group."""
        state = dict(optim_sd["state"])
        held = [(i, d) for i, _, d in self.leaves if i in state]
        if not held:
            return optim_sd
        for key in ("exp_avg", "exp_avg_sq"):
            flat = torch.cat([state[i][key].reshape(-1).float()
                              for i, _ in held])
            parts = [torch.empty_like(flat) for _ in range(self.size)]
            dist.all_gather(parts, flat, group=self.group)
            sizes = [state[i][key].numel() for i, _ in held]
            pieces = [part.split(sizes) for part in parts]
            for n, (i, d) in enumerate(held):
                shape = state[i][key].shape
                whole = torch.cat([p[n].view(shape) for p in pieces], dim=d)
                state[i] = dict(state[i], **{key: whole})
        return dict(optim_sd, state=state)

    def shard_optimizer_state(self, optim_sd: dict) -> dict:
        """The reverse of `whole_optimizer_state`: each sharded leaf's
        whole moments cut to this rank's slice."""
        state = dict(optim_sd["state"])
        for i, _, d in self.leaves:
            if i in state:
                state[i] = {k: self._own(v, d).clone()
                            if k in ("exp_avg", "exp_avg_sq") else v
                            for k, v in state[i].items()}
        return dict(optim_sd, state=state)


def shard_train_state_tp(state, mesh, axis_name: str = "model"):
    """Shard `state` (`train.step.TrainState`, its nets on this rank's
    device) over the (data, model) `mesh`: rank 0's weights broadcast to
    every rank, then each net's `NetShards` over `axis_name` by
    `param_shardings`, and both AdamW optimizers rebuilt over the shards
    and the replicated leaves (fresh moments, shard-shaped from the first
    step). The state takes the mesh's data rank and replicas; its step
    graphs are dropped. Returns `state`."""
    from mb_istft_vits_torch.parallel.mesh import broadcast_weights
    from mb_istft_vits_torch.train.step import fresh_optimizers

    broadcast_weights(state)
    group = mesh.get_group(axis_name)
    rank, size = mesh.get_local_rank(axis_name), mesh[axis_name].size()
    state.shards = {name: NetShards(net, param_shardings(net, size,
                                                         axis_name),
                                    group, rank, size)
                    for name, net in (("g", state.net_g),
                                      ("d", state.net_d))}
    fresh_optimizers(state, state.cfg.train)
    state.tp_mesh = mesh
    state.data_rank = mesh.get_local_rank("data")
    state.data_world = mesh["data"].size()
    if state.graphs is not None:
        state.graphs.clear()
    return state
