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
card; `parallel.tp.shard_train_state_tp`, FSDP2 over a data x model
mesh): each process steps on its own rows of the global batch, as a JAX
host feeds its rows to one SPMD program, and the step's numbers are the
global batch's, as XLA computes them. The gradient average is DDP's (or
FSDP2's); two G losses are ratios over the whole batch (the KL over
sum(z_mask), the duration loss over sum(x_mask)), so their mask sums are
all-reduced before the backward and each rank's term is scaled by
world * local sum / global sum: the average of the ranks' gradients is
then the global loss's. The logged losses are averaged over the ranks,
which makes them the global batch's too. One process, or a group of one,
runs the plain step.

The JAX package splits the step into two programs and re-runs the fake's
subgraph in the first (`Synthesizer.fake_slice`) only to keep each TPU
program small; one forward shared by both halves gives the same fake and
the same draws. Master weights, optimizer state and every loss stay
float32; there is no loss scaling.

Where JAX compiles its two programs once per bucket shape, `train_step`
runs the step as a CUDA graph per batch signature (`train.graphs`) on a
card with a world of 1; `train_step_eager` is the same step kernel by
kernel. So that the body can be captured, it draws nothing and writes no
Python value into the device: the draws come in as tensors (`draw_step`
makes them from the step's generator, in the eager order), the lr is a
0-dim tensor of each capturable optimizer that `write_lr` fills before
the step, and the gradients are zeroed in place, never set to None.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

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

WEIGHT_DECAY = 0.01  # torch.optim.AdamW's default (train_latest.py:103-112)


class StepDraws(NamedTuple):
    """The random draws of one step, shared by both halves: the posterior
    noise [B, T_spec, inter_channels], the decode slice's start frames
    [B] int32 and, for a model with the stochastic duration predictor,
    its posterior noise [B, T_x, 2] (None: drawn from the step's
    generator). Data-parallel, they are the global batch's draws, and
    rank r takes rows [r * B:(r + 1) * B]."""

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

    Data parallel: `ddp_g` / `ddp_d` are the DDP wrappers the forwards go
    through (None: the modules themselves), `data_rank` / `data_world`
    this process's rows of the global batch, and `tp_mesh` the data x
    model mesh when FSDP2 shards the modules (`parallel.tp`).

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
    ddp_g: Optional[torch.nn.Module] = None
    ddp_d: Optional[torch.nn.Module] = None
    data_rank: int = 0
    data_world: int = 1
    tp_mesh: Optional[object] = None
    mas_force: str = "auto"
    graphs: Optional[Any] = dataclasses.field(default=None, repr=False,
                                              compare=False)

    @property
    def device(self) -> torch.device:
        return next(self.net_g.parameters()).device

    @property
    def fwd_g(self) -> torch.nn.Module:
        """The module G's training forward goes through: the DDP wrapper
        arms the gradient all-reduce only when its own forward runs."""
        return self.net_g if self.ddp_g is None else self.ddp_g

    @property
    def fwd_d(self) -> torch.nn.Module:
        return self.net_d if self.ddp_d is None else self.ddp_d

    @property
    def world(self) -> int:
        """Ranks whose gradients are averaged: the process group's when the
        state is data-parallel, else 1."""
        if self.ddp_g is None and self.tp_mesh is None:
            return 1
        return dist.get_world_size()

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
    before every step. On CUDA parameters (not FSDP2's DTensors) it is
    capturable, its lr a 0-dim float32 tensor on their device and its step
    counts device tensors, so that a CUDA graph can hold the update; the
    CPU has no capturable AdamW."""
    params = list(params)
    capturable = (bool(params) and params[0].is_cuda
                  and not any(hasattr(p, "to_local") for p in params))
    lr = (torch.tensor(train_cfg.learning_rate, dtype=torch.float32,
                       device=params[0].device) if capturable
          else train_cfg.learning_rate)
    return torch.optim.AdamW(params, lr=lr, betas=tuple(train_cfg.betas),
                             eps=train_cfg.eps, weight_decay=WEIGHT_DECAY,
                             capturable=capturable)


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
    if any(hasattr(g, "to_local") for g in grads):  # FSDP2's DTensors
        from mb_istft_vits_torch.parallel.tp import global_norm

        return global_norm(grads)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def _reduce_replicated(state: TrainState, params) -> None:
    """Under FSDP2, average the gradients of the parameters it leaves
    replicated (`parallel.tp.param_spec`'s 1-D and indivisible leaves)
    over every rank, as it averages the sharded ones."""
    if state.tp_mesh is None:
        return
    grads = [p.grad for p in params
             if p.grad is not None and not hasattr(p, "to_local")]
    if grads:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat /= dist.get_world_size()
        torch._foreach_copy_(grads, list(flat.split(
            [g.numel() for g in grads])))


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
        # FSDP2's DTensors and plain tensors do not mix in one foreach op
        mixed = any(hasattr(p, "to_local") for p in params)
        torch.nn.utils.clip_grad_value_(params, clip_value,
                                        foreach=False if mixed else None)
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
        return state.fwd_g(batch["x"], batch["x_lengths"], batch["spec"],
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
    bit. A state with a world of 1 (a data-parallel step takes the global
    batch's draws)."""
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
    detached here), through D's forward (DDP's when data-parallel)."""
    with _autocast(state):
        y_d_r, y_d_g, _, _ = state.fwd_d(y, y_hat.detach())
    return discriminator_loss(y_d_r, y_d_g)[0]


def d_step(state: TrainState, y: torch.Tensor, y_hat: torch.Tensor
           ) -> Dict[str, torch.Tensor]:
    """Discriminator step on (real y, fake y_hat [B, 1, T], detached
    here): LSGAN loss, AdamW at the lr the optimizer holds (`write_lr`),
    no clip. The gradients are zeroed in place."""
    loss_disc = d_loss(state, y, y_hat)
    state.optim_d.zero_grad(set_to_none=False)
    loss_disc.backward()
    params = list(state.net_d.parameters())
    _reduce_replicated(state, params)
    grad_norm_d = _global_norm(params)
    optimizer_step(state.optim_d, params, None)
    return {"loss/d/total": loss_disc.detach(), "grad_norm_d": grad_norm_d}


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
    # gradients reach the generator through D, called as the plain module
    # (through DDP it would arm a reduction that never comes); D's own
    # gradients are not needed. FSDP2's sharded parameters keep
    # requires_grad: there the G backward fills D's gradients and the next
    # D step's zero_grad zeroes them.
    toggle = state.tp_mesh is None
    if toggle:
        state.net_d.requires_grad_(False)
    try:
        with _autocast(state):
            _, y_d_g, fmap_r, fmap_g = state.net_d(y, y_hat.transpose(1, 2))
    finally:
        if toggle:
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


def g_step(state: TrainState, batch, out, y: torch.Tensor
           ) -> Dict[str, torch.Tensor]:
    """Generator step against the (already updated) discriminator: the
    losses of `out` (`g_losses`), value clip, AdamW at the lr the optimizer
    holds (`write_lr`), gradients zeroed in place. Data-parallel, the
    KL and duration terms are scaled to the global batch's normalisation
    (module docstring); the losses returned are this rank's terms, whose
    average over the ranks is the global batch's loss."""
    x_mask, y_mask = out[5], out[6]
    world = state.world
    if world > 1:  # the mask sums of the global batch, while G's loss runs
        mask_sums = torch.stack([x_mask.float().sum(), y_mask.float().sum()])
        global_sums = mask_sums.clone()
        pending = dist.all_reduce(global_sums, async_op=True)
    losses = g_losses(state, batch, out, y)
    if world > 1:
        pending.wait()
        scale = world * mask_sums / global_sums
        losses["loss/g/dur"] = losses["loss/g/dur"] * scale[0]
        losses["loss/g/kl"] = losses["loss/g/kl"] * scale[1]
    total = sum(losses.values())
    state.optim_g.zero_grad(set_to_none=False)
    total.backward()
    params = list(state.net_g.parameters())
    _reduce_replicated(state, params)
    grad_norm_g = _global_norm(params)
    optimizer_step(state.optim_g, params, None,
                   state.cfg.train.grad_clip_value)
    metrics = {"loss/g/total": total.detach()}
    metrics.update({k: v.detach() for k, v in losses.items()})
    metrics["grad_norm_g"] = grad_norm_g
    return metrics


def _rank_rows(state: TrainState, draws: Optional[StepDraws], b: int
               ) -> Optional[StepDraws]:
    """This data rank's rows [r * b:(r + 1) * b] of the global draws."""
    if draws is None or state.data_world == 1:
        return draws
    lo = state.data_rank * b
    rows = []
    for v in draws:
        if v is not None and v.shape[0] != b * state.data_world:
            raise ValueError(f"draws of {v.shape[0]} rows for a global batch "
                             f"of {b} x {state.data_world}")
        rows.append(None if v is None else v[lo:lo + b])
    return StepDraws(*rows)


def _average_losses(state: TrainState, metrics: Dict[str, torch.Tensor]
                    ) -> None:
    """The losses in `metrics`, averaged over the ranks in one collective:
    the global batch's values (the gradient norms are already global)."""
    keys = [k for k in metrics if k.startswith("loss/")]
    stacked = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(stacked)
    stacked /= state.world
    metrics.update(zip(keys, stacked.unbind()))


def step_body(state: TrainState, batch: Dict[str, torch.Tensor],
              draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
    """One D step then one G step against the updated D, at the lr the
    optimizers hold, as 0-d metric tensors; what a CUDA graph of the step
    holds. It leaves `state.step` and the lr to its caller."""
    batch = prep_batch(batch, state.cfg)
    out = g_forward(state, batch, _rank_rows(state, draws,
                                             batch["x"].shape[0]))
    y = real_slice(state, batch, out[4])
    metrics = d_step(state, y, out[0].transpose(1, 2))
    metrics.update(g_step(state, batch, out, y))
    if state.world > 1:
        _average_losses(state, metrics)
    return metrics


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
    and `draws` the global batch's; the metrics are the global batch's,
    equal on every rank.

    On a card, a state with a world of 1 steps through its CUDA graphs,
    one per batch signature (`train.graphs.TrainGraphs`: eager warm-up
    steps, then a capture, then replays); on the CPU the body runs
    directly and the signature's key is kept. A data-parallel state (DDP
    or FSDP2) steps eagerly: capturing the collectives is not done."""
    from mb_istft_vits_torch.train.graphs import TrainGraphs, routed

    if not routed(state):
        return train_step_eager(state, batch, draws)
    if state.graphs is None:
        state.graphs = TrainGraphs()
    return state.graphs.step(state, batch, draws)
