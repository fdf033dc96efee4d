"""The GAN training step (counterpart of `mb_istft_vits_tpu/train/step.py`;
reference `train_latest.py:152-266`).

One step, in the reference's own order:
  1. batch prep: int16 wav -> float, linear spectrogram on the device
  2. one generator forward (posterior sample, MAS alignment, random
     decode slice), under bf16 autocast when `fp16_run`
  3. discriminator step on (real slice, detached fake): LSGAN loss,
     AdamW, no clip
  4. generator step against the updated discriminator:
     gen + fm + mel * c_mel + dur + kl * c_kl + sub-band MR-STFT (the
     multi-band head only; 0 for the others), gradients value-clipped at
     `grad_clip_value`, AdamW; dur is the stochastic duration
     predictor's flow NLL when `use_sdp`, computed under the autocast
     like the rest of G and taken in float32, as in JAX
  5. lr = lr0 * lr_decay ^ (step // steps_per_epoch), taken at the step
     count before the increment

Data parallel (`parallel.mesh.shard_train_state_dp`, one process per
card; `parallel.tp.shard_train_state_tp`, over a data x model mesh):
each process steps on its own rows of the global batch, as a JAX host
feeds its rows to one SPMD program, and the step's numbers are the
global batch's, as XLA computes them. Such a step runs in stages
(`step_stages`) with one collective between each two (`drive`,
`collectives`):
  1. forward, D's loss and backward; buffer 1 is [D's gradients | D's
     loss | sum(x_mask), sum(z_mask)]
  2. D's AdamW, G's losses at the global mask sums, G's backward;
     buffer 2 is [G's gradients | G's losses]
  3. G's clip and AdamW, the gradient norms, the metrics
Each buffer is one flat float32 tensor a network (`grad_buffer`), made at
the first step, of which every reduced `p.grad` is a view; the stage
scales the gradients and the losses in it by 1/world and the collective
sums it in place, as DDP's reducer does, so the gradients are the ranks'
average and the losses the global batch's. Two G losses are ratios over
the whole batch (the KL over sum(z_mask), the duration loss over
sum(x_mask)): each rank's term is scaled by world * local sum / global
sum, so the average of the ranks' gradients is the global loss's. A
plain state (no group) runs the same three stages with no buffer and no
collective; a group of one rank runs them with both. While a profiler
runs, each collective between two stages is recorded as the span
`train.collective` (`utils.observability.span`), from its launch to its
return on the host.

A state sharded over a data x model mesh (`TrainState.shards`) averages
its whole gradients over every rank the same way (each "model" rank of a
data replica computes the same ones), then updates only its shards and
all-gathers them over "model" (`parallel.tp.NetShards`). Its step is
five stages and four collectives:
  1. forward, D's loss and backward; all-reduce buffer 1
  2a. D's norm over its whole gradients, AdamW on D's shards (views of
     D's send buffer); all-gather D's shards over "model"
  2b. D's whole parameters from the receive buffer, in place; G's
     losses against the updated D, G's backward; all-reduce buffer 2
  3. G's norm, clip and AdamW on G's shards, the metrics; all-gather G's
     shards
  4. G's whole parameters from the receive buffer, in place

The JAX package splits the step into two programs and re-runs the fake's
subgraph in the first (`Synthesizer.fake_slice`) only to keep each TPU
program small; one forward shared by both halves gives the same fake and
the same draws. Master weights, optimizer state and every loss stay
float32; there is no loss scaling.

Where JAX compiles its two programs once per bucket shape, `train_step`
runs the step as CUDA graphs per batch signature (`train.graphs`) on a
card: one graph of the plain step, or one graph a stage of a
data-parallel or sharded one, with the collectives run eagerly between
their replays; `train_step_eager` is the same step kernel by kernel. So
that a stage can be captured, it draws nothing and writes no Python
value into the device: the draws come in as tensors (`draw_step` makes them from the
step's generator, in the eager order), the lr is a 0-dim tensor of each
capturable optimizer that `write_lr` fills before the step, and the
gradients are zeroed in place, never set to None.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from mb_istft_vits_torch.config import Config, TrainConfig
from mb_istft_vits_torch.dsp.mel import mel_spectrogram, spec_to_mel
from mb_istft_vits_torch.dsp.stft import spectrogram
from mb_istft_vits_torch.losses import (
    discriminator_loss,
    feature_loss,
    generator_loss,
    kl_loss,
    subband_stft_loss,
)
from mb_istft_vits_torch.models import MultiPeriodDiscriminator, Synthesizer
from mb_istft_vits_torch.ops import slice_segments
from mb_istft_vits_torch.utils.observability import span

WEIGHT_DECAY = 0.01  # torch.optim.AdamW's default (train_latest.py:103-112)


class StepDraws(NamedTuple):
    """The random draws of one step, shared by both halves: the posterior
    noise [B, T_spec, inter_channels], the decode slice's start frames
    [B] int32 and, for a model with the stochastic duration predictor,
    its posterior noise [B, T_x, 2] (None: drawn from the step's
    generator). Data-parallel, they are this rank's B rows (`draw_step`'s)
    or the global batch's B x world, of which rank r takes rows
    [r * B:(r + 1) * B]."""

    posterior_eps: torch.Tensor
    ids_slice: torch.Tensor
    sdp_eps: Optional[torch.Tensor] = None


@dataclasses.dataclass
class TrainState:
    """Generator, discriminator, their optimizers and the step count. The
    draws of step n come from a generator seeded by (seed, n) and the data
    rank, so a resumed run repeats them. The lr schedule runs on the
    optimizers' own step count, `step - lr_offset`: `lr_offset` is 0
    unless the optimizers were reset on resume (`train.checkpoint.resume`).

    Data parallel: `dp_group` is the process group whose ranks average
    the gradients (`parallel.mesh.shard_train_state_dp`; None: no data
    parallelism), `data_rank` / `data_world` this process's rows of the
    global batch; `tp_mesh` the data x model mesh of a sharded state and
    `shards` its `parallel.tp.NetShards` of each network ("d", "g"),
    whose shards its optimizers update (`parallel.tp`). `grad_buffers`
    holds the flat gradient buffer of each network that the step's
    collectives reduce (`grad_buffer`).

    `mas_force` routes the alignment (`ops.mas.maximum_path(force=)`);
    `graphs` holds the step's CUDA graphs (`train.graphs.TrainGraphs`,
    made at the first routed step)."""

    cfg: Config
    net_g: Synthesizer
    net_d: MultiPeriodDiscriminator
    optim_g: torch.optim.AdamW
    optim_d: torch.optim.AdamW
    seed: int
    step: int = 0
    lr_offset: int = 0
    dp_group: Optional[Any] = None
    data_rank: int = 0
    data_world: int = 1
    tp_mesh: Optional[object] = None
    mas_force: str = "auto"
    grad_buffers: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    shards: Dict[str, Any] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    graphs: Optional[Any] = dataclasses.field(default=None, repr=False,
                                              compare=False)

    @property
    def device(self) -> torch.device:
        return next(self.net_g.parameters()).device

    @property
    def group(self):
        """The process group the step's gradient all-reduces run over: the
        data-parallel group, every rank of a sharded state's mesh, None
        for a plain state (no collective)."""
        if self.tp_mesh is not None:
            return dist.group.WORLD
        return self.dp_group

    @property
    def world(self) -> int:
        """Ranks whose gradients are averaged: the group's, else 1."""
        group = self.group
        return 1 if group is None else dist.get_world_size(group)

    @property
    def n_model(self) -> int:
        """Ranks a sharded state's leaves are split over, else 1."""
        return next(iter(self.shards.values())).size if self.shards else 1

    def learning_rate(self) -> float:
        """The lr of the next step."""
        return make_lr_schedule(self.cfg)(self.step - self.lr_offset)

    def step_generator(self) -> torch.Generator:
        return torch.Generator(self.device).manual_seed(
            self.seed * 1_000_003 + self.step + (self.data_rank << 32))


def make_lr_schedule(cfg: Config) -> Callable[[int], float]:
    """lr0 * lr_decay ^ epoch of `cfg.train`, stepped per epoch like the
    reference's ExponentialLR (train_latest.py:124-125,134-135)."""
    train_cfg = cfg.train
    spe = max(train_cfg.steps_per_epoch, 1)

    def schedule(step: int) -> float:
        return train_cfg.learning_rate * train_cfg.lr_decay ** (step // spe)

    return schedule


def make_optimizer(params, train_cfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW with the config's betas and eps and weight decay 0.01. Its
    update, -lr * (m_hat / (sqrt(v_hat) + eps) + 0.01 * p), is the JAX
    package's `leaf_adamw`; the trainer sets its lr from the schedule
    before every step. On CUDA parameters (or a sharded state's shards) it
    is capturable, its lr a 0-dim float32 tensor on their device and its
    step counts device tensors, so that a CUDA graph can hold the update;
    the CPU has no capturable AdamW."""
    params = list(params)
    capturable = bool(params) and params[0].is_cuda
    lr = (torch.tensor(train_cfg.learning_rate, dtype=torch.float32,
                       device=params[0].device) if capturable
          else train_cfg.learning_rate)
    return torch.optim.AdamW(params, lr=lr, betas=tuple(train_cfg.betas),
                             eps=train_cfg.eps, weight_decay=WEIGHT_DECAY,
                             capturable=capturable)


def fresh_optimizers(state: TrainState, train_cfg: TrainConfig) -> None:
    """Both of `state`'s optimizers made anew (`make_optimizer`) over what
    each net's step updates: its parameters, or a sharded state's shards
    in place of the leaves it shards (`parallel.tp.NetShards`)."""
    for name, net in (("g", state.net_g), ("d", state.net_d)):
        shards = state.shards.get(name)
        params = (net.parameters() if shards is None
                  else shards.optimizer_params(net))
        setattr(state, f"optim_{name}", make_optimizer(params, train_cfg))


def create_train_state(cfg: Config, device: torch.device,
                       seed: int) -> TrainState:
    """Generator and discriminator with torch's default init, drawn from
    `seed`, on `device`; fresh optimizers."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net_g = Synthesizer(cfg.model)
        net_d = MultiPeriodDiscriminator()
    net_g, net_d = net_g.to(device).train(), net_d.to(device).train()
    return TrainState(cfg, net_g, net_d,
                      make_optimizer(net_g.parameters(), cfg.train),
                      make_optimizer(net_d.parameters(), cfg.train), seed)


def prep_batch(batch: Dict[str, torch.Tensor], cfg: Config
               ) -> Dict[str, torch.Tensor]:
    """int16 wav [B, T_wav, 1] -> float32 / max_wav_value; unless the batch
    carries "spec", the linear spectrogram [B, T_spec, bins] is computed
    here, on the batch's device. The collate sized the wav buffer
    t_spec * hop + (n_fft - hop), so the frames past t_spec are cut."""
    d = cfg.data
    wav = batch["wav"]
    if not wav.is_floating_point():
        wav = wav.float() * (1.0 / d.max_wav_value)
    out = dict(batch, wav=wav)
    if "spec" not in batch:
        t_spec = (wav.shape[1] - (d.filter_length - d.hop_length)
                  ) // d.hop_length
        mag = spectrogram(wav[..., 0], d.filter_length, d.hop_length,
                          d.win_length)
        out["spec"] = mag.transpose(1, 2)[:, :t_spec]
    return out


def _autocast(state: TrainState):
    """bf16 autocast around the G and D compute when `fp16_run`, without
    its cache of cast weights (a CUDA graph must not keep one)."""
    if not state.cfg.train.fp16_run:
        return contextlib.nullcontext()
    return torch.autocast(state.device.type, dtype=torch.bfloat16,
                          cache_enabled=False)


def _global_norm(params) -> torch.Tensor:
    grads = [p.grad for p in params if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def optimizer_params(optim: torch.optim.Optimizer) -> List[torch.Tensor]:
    """What `optim` updates, in order: a net's parameters, or a sharded
    state's shards in place of the leaves it shards."""
    return [p for group in optim.param_groups for p in group["params"]]


def grad_buffer(state: TrainState, name: str, params, tail: int
                ) -> torch.Tensor:
    """The flat float32 buffer of network `name` ("d" or "g") that a
    collective reduces: the gradients of `params` that the step reduces
    (each one it has made), then `tail`
    more values. Made at the first call, outside any graph pool, from the
    gradients the step has just made, each of which becomes a view of it:
    autograd then accumulates into the view in place, and
    `zero_grad(set_to_none=False)` zeroes it there. A parameter that has
    no gradient then is left out and keeps None, so AdamW skips it, as
    it does in the plain step. Later calls check that each reduced
    gradient is still a view of the buffer: one that appeared after it
    was made, or was replaced, raises."""
    grads = [p for p in params if p.grad is not None]
    buf = state.grad_buffers.get(name)
    if buf is None:
        sizes = [p.numel() for p in grads]
        buf = torch.zeros(sum(sizes) + tail, dtype=torch.float32,
                          device=state.device)
        for p, view in zip(grads, buf[:sum(sizes)].split(sizes)):
            view = view.view(p.shape)
            view.copy_(p.grad)
            p.grad = view
        state.grad_buffers[name] = buf
    else:
        stray = sum(1 for p in grads if p.grad._base is not buf)
        if stray:
            raise RuntimeError(
                f"{stray} gradient(s) of net {name} are not views of its "
                "flat buffer: every reduced gradient must exist at the "
                "first step and be written in place")
    return buf


def _fill(state: TrainState, name: str, params, scaled: torch.Tensor,
          summed: Optional[torch.Tensor] = None) -> None:
    """Buffer `name` ready for its collective: [gradients | `scaled` |
    `summed`], the gradients (already in it) and `scaled` times 1/world,
    as DDP's reducer scales a gradient into its bucket, `summed` as it
    is."""
    tail = scaled.numel() + (0 if summed is None else summed.numel())
    buf = grad_buffer(state, name, params, tail)
    k = buf.numel() - tail + scaled.numel()
    buf[k - scaled.numel():k].copy_(scaled)
    buf[:k].mul_(1.0 / state.world)
    if summed is not None:
        buf[k:].copy_(summed)


REDUCED = ("d", "g")  # the buffer all-reduce i of a step sums


def all_reduce_buffer(state: TrainState, i: int) -> None:
    """All-reduce i of a data-parallel step: buffer REDUCED[i] summed over
    the state's group, in place, on the current stream."""
    dist.all_reduce(state.grad_buffers[REDUCED[i]], group=state.group)


def collectives(state: TrainState) -> List[Callable[[], None]]:
    """The collectives between the stages of `state`'s step, in order: none
    for a plain state; the two buffer all-reduces for a data-parallel one;
    for a sharded one each all-reduce followed by that net's all-gather
    of its shards over "model" (module docstring)."""
    if state.group is None:
        return []
    reduce = [lambda i=i: all_reduce_buffer(state, i) for i in range(2)]
    if not state.shards:
        return reduce
    return [reduce[0], state.shards["d"].gather, reduce[1],
            state.shards["g"].gather]


def set_lr(optim: torch.optim.AdamW, lr: float) -> None:
    """Every group's lr: filled into the lr tensor of a capturable
    optimizer (the tensor a captured update reads), else assigned."""
    for group in optim.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def write_lr(state: TrainState) -> None:
    """The schedule's lr of the next step into both optimizers."""
    lr = state.learning_rate()
    set_lr(state.optim_d, lr)
    set_lr(state.optim_g, lr)


def optimizer_step(optim: torch.optim.AdamW, params, lr: Optional[float],
                   clip_value: Optional[float] = None) -> None:
    """Value-clip the gradients of `params` (when `clip_value` is given,
    reference commons.py:146-161), then one AdamW step at `lr` (None: at
    the lr the optimizer holds, which `write_lr` wrote)."""
    if clip_value is not None:
        torch.nn.utils.clip_grad_value_(params, clip_value)
    if lr is not None:
        set_lr(optim, lr)
    optim.step()


def g_forward(state: TrainState, batch: Dict[str, torch.Tensor],
              draws: Optional[StepDraws] = None):
    """The step's one generator forward (`Synthesizer.forward`'s tuple);
    without `draws`, they come from the step's generator."""
    draws = draws or StepDraws(None, None)
    # with every draw given there is no generator: torch refuses to make a
    # CUDA generator while a graph is captured
    drawn = (draws.posterior_eps is not None and draws.ids_slice is not None
             and (draws.sdp_eps is not None or not state.cfg.model.use_sdp))
    with _autocast(state):
        return state.net_g(batch["x"], batch["x_lengths"], batch["spec"],
                           batch["spec_lengths"], batch.get("sid"),
                           posterior_eps=draws.posterior_eps,
                           ids_slice=draws.ids_slice, sdp_eps=draws.sdp_eps,
                           generator=None if drawn
                           else state.step_generator(),
                           mas_force=state.mas_force)


def draw_step(state: TrainState, batch: Dict[str, torch.Tensor]
              ) -> StepDraws:
    """The draws `g_forward` would take from the step's generator for
    `batch` (the collate's, before `prep_batch`), in its order and dtypes:
    the posterior noise [B, C, T_spec] (float32: under `fp16_run`'s
    autocast the encoder's bf16 projection is multiplied by a float32 mask
    before the draw takes its dtype), the stochastic duration predictor's
    noise [B, T_x, 2] (float32 likewise), then the slice's uniform [B].
    Passed as `draws`, they give the step that drew them itself, bit for
    bit. A data-parallel state draws its own rows from its own generator
    (the data rank is in its seed), as its step does."""
    d, m = state.cfg.data, state.cfg.model
    b, t_x = batch["x"].shape
    if "spec" in batch:
        t_spec = batch["spec"].shape[1]
    else:
        t_spec = (batch["wav"].shape[1] - (d.filter_length - d.hop_length)
                  ) // d.hop_length
    dev = batch["x"].device
    gen = state.step_generator()
    eps = torch.randn((b, m.inter_channels, t_spec), generator=gen,
                      dtype=torch.float32, device=dev).transpose(1, 2)
    sdp_eps = (torch.randn((b, t_x, 2), generator=gen, dtype=torch.float32,
                           device=dev) if m.use_sdp else None)
    u = torch.rand(b, generator=gen, device=dev)
    top = torch.clamp(batch["spec_lengths"] - m.segment_size + 1, min=1)
    return StepDraws(eps, (u * top).to(torch.int32), sdp_eps)


def real_slice(state: TrainState, batch, ids_slice) -> torch.Tensor:
    """Ground-truth waveform slice [B, 1, segment_size] at the decode
    slice's frames (train_latest.py:186)."""
    return slice_segments(batch["wav"].transpose(1, 2),
                          ids_slice * state.cfg.data.hop_length,
                          state.cfg.train.segment_size)


def d_loss(state: TrainState, y: torch.Tensor, y_hat: torch.Tensor
           ) -> torch.Tensor:
    """The discriminator's LSGAN loss on (real y, fake y_hat [B, 1, T],
    detached here)."""
    with _autocast(state):
        y_d_r, y_d_g, _, _ = state.net_d(y, y_hat.detach())
    return discriminator_loss(y_d_r, y_d_g)[0]


def d_backward(state: TrainState, y: torch.Tensor, y_hat: torch.Tensor
               ) -> torch.Tensor:
    """D's LSGAN loss on (real y, fake y_hat [B, 1, T], detached), its
    gradients zeroed in place, then its backward; returns the loss,
    detached."""
    loss_disc = d_loss(state, y, y_hat)
    state.net_d.zero_grad(set_to_none=False)
    loss_disc.backward()
    return loss_disc.detach()


def d_update(state: TrainState) -> torch.Tensor:
    """D's gradient norm, then its AdamW step at the lr the optimizer holds
    (`write_lr`), no clip (a sharded state's on its shards, their
    gradients taken from the whole ones first); returns the norm."""
    grad_norm_d = _global_norm(state.net_d.parameters())
    if state.shards:
        state.shards["d"].take_grads()
    optimizer_step(state.optim_d, optimizer_params(state.optim_d), None)
    return grad_norm_d


def d_step(state: TrainState, y: torch.Tensor, y_hat: torch.Tensor
           ) -> Dict[str, torch.Tensor]:
    """Discriminator step on (real y, fake y_hat [B, 1, T], detached
    here): `d_backward`, then `d_update`."""
    loss_disc = d_backward(state, y, y_hat)
    return {"loss/d/total": loss_disc, "grad_norm_d": d_update(state)}


def g_losses(state: TrainState, batch, out, y: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    """The generator's losses of `out` (the step's forward) against the
    (already updated) discriminator, each normalised over this process's
    rows: the KL over their sum(z_mask), the duration loss over their
    sum(x_mask). The sub-band MR-STFT loss is the multi-band head's only
    (JAX `train/step.py:457`); for the others it is 0."""
    d, t = state.cfg.data, state.cfg.train
    (y_hat, y_hat_mb, l_length, _, ids_slice, x_mask, y_mask,
     (_, z_p, m_p, logs_p, _, logs_q)) = out
    seg_frames = t.segment_size // d.hop_length
    with torch.no_grad():
        spec = slice_segments(batch["spec"].transpose(1, 2).float(),
                              ids_slice, seg_frames)
        y_mel = spec_to_mel(spec, d.filter_length, d.n_mel_channels,
                            d.sampling_rate, d.mel_fmin, d.mel_fmax)
    y_hat_mel = mel_spectrogram(y_hat[..., 0].float(), d.filter_length,
                                d.n_mel_channels, d.sampling_rate,
                                d.hop_length, d.win_length, d.mel_fmin,
                                d.mel_fmax)
    # gradients reach the generator through D, whose own gradients are
    # not needed; frozen, D takes the real half alone without autograd
    state.net_d.requires_grad_(False)
    try:
        with _autocast(state):
            _, y_d_g, fmap_r, fmap_g = state.net_d(y, y_hat.transpose(1, 2))
    finally:
        state.net_d.requires_grad_(True)
    return {
        "loss/g/gen": generator_loss(y_d_g)[0],
        "loss/g/fm": feature_loss(fmap_r, fmap_g),
        "loss/g/mel": torch.mean(torch.abs(y_mel - y_hat_mel)) * t.c_mel,
        "loss/g/dur": torch.sum(l_length.float()),
        "loss/g/kl": kl_loss(z_p, logs_q, m_p, logs_p, y_mask) * t.c_kl,
        "loss/g/subband": subband_stft_loss(
            state.net_g.dec.pqmf.analysis_bm(y.float()), y_hat_mb,
            t.fft_sizes, t.hop_sizes, t.win_lengths)
        if state.cfg.model.mb_istft_vits
        else torch.zeros((), device=y.device),
    }


def g_backward(state: TrainState, batch, out, y: torch.Tensor,
               scale: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """G's losses of `out` (`g_losses`), the duration and KL terms times
    `scale` [2] when given (data-parallel: world * this rank's mask sums /
    the global batch's, module docstring), their sum, G's gradients
    zeroed in place, then the sum's backward. Returns the sum
    ("loss/g/total") and the terms, detached."""
    losses = g_losses(state, batch, out, y)
    if scale is not None:
        losses["loss/g/dur"] = losses["loss/g/dur"] * scale[0]
        losses["loss/g/kl"] = losses["loss/g/kl"] * scale[1]
    total = sum(losses.values())
    state.net_g.zero_grad(set_to_none=False)
    total.backward()
    metrics = {"loss/g/total": total.detach()}
    metrics.update({k: v.detach() for k, v in losses.items()})
    return metrics


def g_update(state: TrainState) -> torch.Tensor:
    """G's gradient norm, value clip, then AdamW at the lr the optimizer
    holds (`write_lr`; a sharded state's on its shards, as `d_update`);
    returns the norm."""
    grad_norm_g = _global_norm(state.net_g.parameters())
    if state.shards:
        state.shards["g"].take_grads()
    optimizer_step(state.optim_g, optimizer_params(state.optim_g), None,
                   state.cfg.train.grad_clip_value)
    return grad_norm_g


def g_step(state: TrainState, batch, out, y: torch.Tensor
           ) -> Dict[str, torch.Tensor]:
    """Generator step against the (already updated) discriminator:
    `g_backward`, then `g_update`."""
    metrics = g_backward(state, batch, out, y)
    metrics["grad_norm_g"] = g_update(state)
    return metrics


def _rank_rows(state: TrainState, draws: Optional[StepDraws], b: int
               ) -> Optional[StepDraws]:
    """This data rank's rows of `draws`: b rows are its own (`draw_step`
    draws them), b x world the global batch's, of which it takes rows
    [r * b:(r + 1) * b]."""
    if draws is None or state.data_world == 1:
        return draws
    lo = state.data_rank * b
    rows = []
    for v in draws:
        if v is not None and v.shape[0] == b * state.data_world:
            v = v[lo:lo + b]
        elif v is not None and v.shape[0] != b:
            raise ValueError(f"draws of {v.shape[0]} rows for {b} rows a "
                             f"rank of {state.data_world}")
        rows.append(v)
    return StepDraws(*rows)


def _forward(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: Optional[StepDraws]):
    """(the prepped batch, the generator forward's tuple, the real
    slice)."""
    batch = prep_batch(batch, state.cfg)
    out = g_forward(state, batch, _rank_rows(state, draws,
                                             batch["x"].shape[0]))
    return batch, out, real_slice(state, batch, out[4])


Stage = Callable[[], Optional[Dict[str, torch.Tensor]]]


def step_stages(state: TrainState, batch: Dict[str, torch.Tensor],
                draws: Optional[StepDraws] = None) -> List[Stage]:
    """The step as stages over one context, for `drive`: (1) the forward
    and D's backward, (2) D's update and G's backward, (3) G's update and
    the metrics. A data-parallel state's stages 1 and 2 end at the fill of
    the buffer their collective reduces (module docstring); a plain
    state's do not, and its stages are `d_step` then `g_step`, op for op.
    A sharded state's stage 2 is two, split at D's all-gather, and a
    fifth puts G's gathered shards into its whole parameters. The last
    stage returns the metrics as 0-d tensors, the others None."""
    ctx: Dict[str, Any] = {}
    reduced = state.group is not None
    shards = state.shards

    def forward_d():
        ctx["batch"], out, y = _forward(state, batch, draws)
        ctx["out"], ctx["y"] = out, y
        ctx["loss/d/total"] = d_backward(state, y, out[0].transpose(1, 2))
        if reduced:
            # sum(x_mask) and sum(z_mask), summed over the ranks
            ctx["mask_sums"] = torch.stack([out[5].float().sum(),
                                            out[6].float().sum()])
            _fill(state, "d", state.net_d.parameters(),
                  ctx["loss/d/total"].float().reshape(1), ctx["mask_sums"])

    def update_d():
        ctx["grad_norm_d"] = d_update(state)

    def backward_g():
        if shards:
            shards["d"].put_whole()
        else:
            update_d()
        scale = (state.world * ctx["mask_sums"]
                 / state.grad_buffers["d"][-2:] if reduced else None)
        ctx["losses"] = g_backward(state, ctx["batch"], ctx["out"], ctx["y"],
                                   scale)
        if reduced:
            _fill(state, "g", state.net_g.parameters(),
                  torch.stack([v.float() for v in ctx["losses"].values()]))

    def update_g():
        grad_norm_g = g_update(state)
        losses = ctx["losses"]
        metrics = {"loss/d/total": ctx["loss/d/total"],
                   "grad_norm_d": ctx["grad_norm_d"]}
        if reduced:
            # the global batch's, copied out: the next step writes the
            # buffers again
            summed = torch.cat([state.grad_buffers["d"][-3:-2],
                                state.grad_buffers["g"][-len(losses):]])
            metrics["loss/d/total"] = summed[0]
            losses = dict(zip(losses, summed[1:].unbind()))
        metrics.update(losses)
        metrics["grad_norm_g"] = grad_norm_g
        ctx.clear()
        if not shards:
            return metrics
        ctx["metrics"] = metrics
        return None

    def put_g():
        shards["g"].put_whole()
        return ctx.pop("metrics")

    if shards:
        return [forward_d, update_d, backward_g, update_g, put_g]
    return [forward_d, backward_g, update_g]


def drive(state: TrainState, run: Callable[[int], Any], n: int) -> Any:
    """Part i of `n` as `run(i)`, in order, with the state's collective i
    (`collectives`) between parts i and i + 1; returns the last part's
    result. The eager step and the step graphs' warm-ups, captures and
    replays all run a step so: a part is a stage, or a plain state's
    three stages in one. A plain state has no collectives and runs its
    parts back to back; any other state raises unless it has one
    collective between each two parts."""
    schedule = collectives(state)
    if schedule and len(schedule) != n - 1:
        raise ValueError(f"{n} parts for {len(schedule)} collectives")
    out = None
    for i in range(n):
        if i and schedule:
            with span("train.collective"):
                schedule[i - 1]()
        out = run(i)
    return out


def step_body(state: TrainState, batch: Dict[str, torch.Tensor],
              draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
    """One D step then one G step against the updated D, at the lr the
    optimizers hold, as 0-d metric tensors: `step_stages` through
    `drive`. It leaves `state.step` and the lr to its caller."""
    stages = step_stages(state, batch, draws)
    return drive(state, lambda i: stages[i](), len(stages))


def train_step_eager(state: TrainState, batch: Dict[str, torch.Tensor],
                     draws: Optional[StepDraws] = None
                     ) -> Dict[str, torch.Tensor]:
    """`train_step` kernel by kernel, never through a graph."""
    write_lr(state)
    metrics = step_body(state, batch, draws)
    metrics["learning_rate"] = torch.tensor(state.learning_rate())
    state.step += 1
    return metrics


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
    """One D step then one G step against the updated D; advances
    `state.step`. `batch` holds the collate's tensors on the model's
    device ("x", "x_lengths", "wav" int16 or float [B, T_wav, 1],
    "spec_lengths", optionally "spec", and "sid" [B] for a multi-speaker
    model). Returns the JAX package's metrics as 0-d tensors (reading
    them waits for the device). Data-parallel, `batch` is this rank's rows
    and `draws` its own rows or the global batch's (`StepDraws`); the
    metrics are the global batch's, equal on every rank.

    On a card, a state steps through its CUDA graphs, one set per batch
    signature (`train.graphs.TrainGraphs`: eager warm-up steps, then a
    capture, then replays; a data-parallel or sharded state a graph a
    stage, with its collectives between); on the CPU the body runs
    directly and the signature's key is kept."""
    from mb_istft_vits_torch.train.graphs import TrainGraphs

    if state.graphs is None:
        state.graphs = TrainGraphs()
    return state.graphs.step(state, batch, draws)
