"""Training traffic: the port's one-card training step at a configuration's
published batch, on rows of the corpus padded to the trainer's length
buckets, in a fixed cycle of buckets.

Set-up is the trainer's (`mb_istft_vits_torch.train.loop`): float32 with
TF32 off (`disable_tf32`), torch's generator seeded for dropout, one
`TrainState` (`create_train_state`) given the benchmark's weights. The
bucket cycle and its rows are the same for every seed (one fixed set of
rows a bucket, drawn once), so every seed's cycle holds the same audio;
the seed deals those rows out over each bucket's steps and draws the
rows' audio, each step's draws (the posterior noise and the slice
starts, handed to `train_step`) and the weights. Every batch is made on
the device at set-up, in the collate's layout, so the window feeds
nothing from the host.

The state's first three steps are the checked ones: three batches of the
cycle's first bucket, of rows the seed draws from the rest of it (the
signature's two eager warm-ups and its capture), dropout seeded before
each. Then every other bucket of the cycle takes its warm-ups and
capture, in the cycle's order, the same for every seed (the order of the
captures moves the window's rate). Each of these captures' step, the
first replay of its signature, is held too: the state's weights and the
discriminator's AdamW moments are copied to the host before it, and its
dropout is seeded. The window replays the cycle from its start until
`seconds` have passed, keeping at most two steps in flight. After it,
the state is freed and the plain reference (`perfbench.reference.train`)
runs the three checked steps from the same weights, batches, draws and
dropout seeds, and each other signature's first replay from the copy
taken before it."""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import train as reference
from perfbench.reference.precision import float32
from perfbench.yardstick import compare, corpus, flops, weights

CHECK_STEPS = 3
TRAILING_STEPS = 2


def _leaves(state) -> List[tuple]:
    return ([("g." + k, tuple(p.shape)) for k, p in
             state.net_g.named_parameters()]
            + [("d." + k, tuple(p.shape)) for k, p in
               state.net_d.named_parameters()])


def _named(state):
    yield from (("g." + k, p, state.optim_g) for k, p in
                state.net_g.named_parameters())
    yield from (("d." + k, p, state.optim_d) for k, p in
                state.net_d.named_parameters())


def _batch(rows: List[corpus.Row], bucket: int, cap: int, data, device,
           gen: torch.Generator, audio_rms: float, speakers: bool):
    """The collate's device-spec batch of `rows` at the bucket's frames:
    x [B, cap] int32, x_lengths, spec_lengths [B] int32, wav int16
    [B, frames * hop + n_fft - hop, 1] (each row's samples seeded noise,
    zeros after), sid [B] for a multi-speaker corpus; and each row's
    (ids, frames, samples)."""
    hop = data["hop_length"]
    t_spec = corpus.BOUNDARIES[bucket + 1]
    t_wav = t_spec * hop + data["filter_length"] - hop
    b = len(rows)
    x = np.zeros((b, cap), np.int32)
    for i, r in enumerate(rows):
        x[i, :len(r.ids)] = r.ids
    samples = torch.tensor([r.samples for r in rows], device=device)
    noise = torch.randn((b, t_wav), generator=gen, device=device)
    keep = torch.arange(t_wav, device=device)[None] < samples[:, None]
    wav = (noise * (audio_rms * data["max_wav_value"])).round_().clamp_(
        -32768, 32767).mul_(keep).to(torch.int16)[..., None]
    batch = {
        "x": torch.from_numpy(x).to(device),
        "x_lengths": torch.tensor([len(r.ids) for r in rows],
                                  dtype=torch.int32, device=device),
        "wav": wav,
        "spec_lengths": torch.tensor([min(r.samples // hop, t_spec)
                                      for r in rows], dtype=torch.int32,
                                     device=device),
    }
    if speakers:
        batch["sid"] = torch.tensor([r.sid for r in rows], dtype=torch.int32,
                                    device=device)
    lengths = [(len(r.ids), min(r.samples // hop, t_spec), r.samples)
               for r in rows]
    return batch, lengths


def _draws(batch, cfg, gen: torch.Generator):
    """The step's posterior noise [B, T_spec, C] and slice starts [B], in
    `train.step.draw_step`'s layout and dtypes."""
    from mb_istft_vits_torch.train.step import StepDraws

    d, m = cfg.data, cfg.model
    b = batch["x"].shape[0]
    t_spec = (batch["wav"].shape[1] - (d.filter_length - d.hop_length)) \
        // d.hop_length
    dev = batch["x"].device
    eps = torch.randn((b, m.inter_channels, t_spec), generator=gen,
                      device=dev).transpose(1, 2)
    u = torch.rand(b, generator=gen, device=dev)
    top = torch.clamp(batch["spec_lengths"] - m.segment_size + 1, min=1)
    return StepDraws(eps, (u * top).to(torch.int32))


def _seed_dropout(seed: int, device) -> None:
    if device.type == "cuda":
        torch.cuda.manual_seed(seed)
    else:
        torch.manual_seed(seed)


def _losses(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k[len("loss/"):]: float(v) for k, v in metrics.items()
            if k.startswith("loss/")}


class TrainRun:
    """One training cell's run in its phases: set-up (`__init__`, then
    `first_steps` and `warm`), `window`, `free`, `reference`."""

    def __init__(self, ctx):
        from mb_istft_vits_torch.config import Config
        from mb_istft_vits_torch.device import disable_tf32
        from mb_istft_vits_torch.train.step import (create_train_state,
                                                    train_step)

        self.ctx, self.train_step = ctx, train_step
        wl, conf, device = ctx.workload, ctx.config, ctx.device
        seed = ctx.seed
        if device.type == "cuda":
            disable_tf32()
        torch.manual_seed(seed % (1 << 63))  # dropout, as the trainer does
        self.rng = rng = np.random.default_rng(seed)
        gen = torch.Generator(device).manual_seed(seed % (1 << 63))
        c, d = conf["corpus"], conf["data"]
        rows = corpus.load_rows(c["table"], c["module"], c["speakers"],
                                d.get("min_text_len", 1),
                                d.get("max_text_len", 190))
        buckets = corpus.bucket_rows(rows, d["hop_length"])
        if "buckets" in wl:
            buckets = {b: v for b, v in buckets.items()
                       if b in wl["buckets"]}
        batch_size = wl["batch"]
        cfg = Config.from_json(ctx.config_path)
        self.cfg = cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=batch_size,
            steps_per_epoch=corpus.steps_per_epoch(buckets, batch_size)))
        self.cap = cap = 2 * cfg.data.max_text_len + 1
        self.order = order = corpus.cycle(buckets, wl["cycle_steps"])
        # the cycle's rows are one fixed set, the same for every seed (so
        # every seed trains on the same audio a cycle); the seed deals
        # them out over each bucket's steps
        fixed = np.random.default_rng(0)
        dealt: Dict[int, List[int]] = {}
        for b in sorted(set(order)):
            pool = corpus.draw_rows(fixed, buckets[b],
                                    batch_size * order.count(b))
            dealt[b] = [int(i) for i in rng.permutation(pool)]
        used = {i for v in dealt.values() for i in v}

        def make(bucket, picked):
            batch, lengths = _batch([rows[i] for i in picked], bucket, cap,
                                    d, device, gen, wl["audio_rms"],
                                    c["speakers"])
            return batch, _draws(batch, cfg, gen), lengths

        # the checked steps' rows: drawn by the seed, each its own
        self.checked = []
        for _ in range(CHECK_STEPS):
            picked = corpus.draw_rows(rng, buckets[order[0]], batch_size,
                                      used)
            used.update(picked)
            self.checked.append(make(order[0], picked))
        self.steps = []
        for b in order:
            self.steps.append(make(b, dealt[b][:batch_size]))
            del dealt[b][:batch_size]
        ctx.log(f"{len(self.steps)} batches made, cycle {order}")
        self.state = create_train_state(cfg, device, seed % (1 << 63))
        self.start = weights.make(_leaves(self.state), seed, device,
                                  cfg.model.hidden_channels,
                                  wl.get("weight_overrides"))
        with torch.no_grad():
            for name, p, _ in _named(self.state):
                p.copy_(self.start[name])
        self.dropout_seeds = [int(rng.integers(1 << 62))
                              for _ in range(CHECK_STEPS)]
        self.replays: List[Dict] = []
        ctx.log("state made")

    def first_steps(self) -> Dict:
        """The checked steps, the state's first, through the window's
        call: each step's losses, the first gradients as the optimizers
        hold them (Adam's first moment over 1 - beta1), each leaf's change
        over the steps."""
        state, beta1 = self.state, self.cfg.train.betas[0]
        prog: Dict = {"losses": []}
        self.lrs = []
        for k, (batch, draws, _) in enumerate(self.checked):
            self.lrs.append(state.learning_rate())
            _seed_dropout(self.dropout_seeds[k], self.ctx.device)
            prog["losses"].append(_losses(self.train_step(state, batch,
                                                          draws)))
            if k == 0:
                prog["grad_norms"] = {
                    name: float(opt.state[p]["exp_avg"].double().norm()
                                / (1 - beta1))
                    for name, p, opt in _named(state)
                    if p in opt.state and "exp_avg" in opt.state[p]}
        with torch.no_grad():
            prog["change_norms"] = {
                name: float((p.double() - self.start[name].double()).norm())
                for name, p, _ in _named(state)}
        self.ctx.log("checked steps done")
        return prog

    def warm(self) -> List[Dict[str, float]]:
        """Every other bucket's warm-up steps and capture, in the cycle's
        order; each capture's step (the signature's first replay) with
        the state copied to the host before it (`self.replays`) and its
        dropout seeded. Returns those steps' losses."""
        seen = {self.order[0]}
        self.replays = []
        for i, b in enumerate(self.order):
            if b not in seen:
                seen.add(b)
                batch, draws = self.steps[i][:2]
                for _ in range(CHECK_STEPS - 1):
                    self.train_step(self.state, batch, draws)
                held = self._held()
                held.update(batch=batch, draws=draws,
                            lr=self.state.learning_rate(),
                            seed=int(self.rng.integers(1 << 62)))
                _seed_dropout(held["seed"], self.ctx.device)
                held["losses"] = _losses(self.train_step(self.state, batch,
                                                         draws))
                self.replays.append(held)
                self.ctx.log(f"bucket {b} warm")
        return [h["losses"] for h in self.replays]

    def _held(self) -> Dict:
        """The state's weights, and the discriminator's AdamW moments
        and step count, copied to the host."""
        def host(t):
            return t.detach().to("cpu", copy=True)

        held: Dict = {"weights": {}, "d_moments": {}}
        for name, p, opt in _named(self.state):
            held["weights"][name] = host(p)
            if name.startswith("d.") and p in opt.state:
                st = opt.state[p]
                held["d_moments"][name[2:]] = (host(st["exp_avg"]),
                                               host(st["exp_avg_sq"]))
                held["d_step"] = int(float(st["step"]))
        return held

    def window(self) -> Dict:
        """Replays the cycle for the window's seconds, at most two steps
        in flight; in a traced run, two trailing steps after it."""
        ctx, steps, state = self.ctx, self.steps, self.state
        d = ctx.config["data"]
        audio = [sum(s for _, _, s in lengths) / d["sampling_rate"]
                 for _, _, lengths in steps]
        step_flops = [flops.step_flops(ctx.config, [(tx, ty) for tx, ty, _
                                                    in lengths])
                      for _, _, lengths in steps]
        mas = [(corpus.BOUNDARIES[b + 1], self.cap,
                [(ty, tx) for tx, ty, _ in steps[i][2]])
               for i, b in enumerate(self.order)]
        done = 0
        flight: List = []
        with ctx.tracer:
            with ctx.tracer.window():
                t0 = time.perf_counter()
                while True:
                    batch, draws, _ = steps[done % len(steps)]
                    with ctx.tracer.range("perfbench.step"):
                        self.train_step(state, batch, draws)
                    flight.append(ctx.event())
                    if len(flight) > 2:
                        flight.pop(0).synchronize()
                    done += 1
                    if time.perf_counter() - t0 >= ctx.seconds:
                        break
                ctx.sync()
                window_s = time.perf_counter() - t0
            if ctx.tracer.enabled:
                with ctx.tracer.trailing():
                    for i in range(TRAILING_STEPS):
                        self.train_step(state,
                                        *steps[(done + i) % len(steps)][:2])
                    ctx.sync()
        ctx.log(f"window: {done} steps in {window_s:.3f} s")
        window = [i % len(steps) for i in range(done)]
        return {"steps": done, "window_s": window_s,
                "audio_s": sum(audio[i] for i in window),
                "flops": sum(step_flops[i] for i in window),
                "precision": ctx.precision(),
                "mas_shapes": [mas[i] for i in window]}

    def free(self) -> None:
        """Drops the program's state and its graphs."""
        self.state = self.steps = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, rows: Optional[int] = None) -> Dict:
        """The reference's readings of the checked steps, from the same
        weights, batches, draws, learning rates and dropout seeds (of
        each batch's first `rows` rows, where given), and of each other
        signature's first replay."""
        rows = rows or self.checked[0][0]["x"].shape[0]
        steps = [({k: v[:rows] for k, v in batch.items()},
                  {"posterior_eps": draws.posterior_eps.transpose(1, 2)[:rows],
                   "ids_slice": draws.ids_slice[:rows]})
                 for batch, draws, _ in self.checked]
        g_w = {k[2:]: v for k, v in self.start.items() if k.startswith("g.")}
        d_w = {k[2:]: v for k, v in self.start.items() if k.startswith("d.")}
        out = reference.run(self.ctx.config, g_w, d_w, steps, self.lrs,
                            self.dropout_seeds)
        out["replays"] = self.reference_replays(rows)
        self.ctx.log("reference done")
        return out

    def reference_replays(self, rows: int) -> List[Dict[str, float]]:
        """The reference's losses of each other signature's first replay,
        from the state copied before it, over its batch's first `rows`
        rows."""
        dev = self.ctx.device
        out = []
        for h in self.replays:
            w = {k: v.to(dev) for k, v in h["weights"].items()}
            moments = {k: (m.to(dev), v.to(dev))
                       for k, (m, v) in h["d_moments"].items()}
            draws = {"posterior_eps":
                     h["draws"].posterior_eps.transpose(1, 2)[:rows],
                     "ids_slice": h["draws"].ids_slice[:rows]}
            out.append(reference.replay(
                self.ctx.config,
                {k[2:]: v for k, v in w.items() if k.startswith("g.")},
                {k[2:]: v for k, v in w.items() if k.startswith("d.")},
                moments, h.get("d_step", 0),
                {k: v[:rows] for k, v in h["batch"].items()}, draws,
                h["lr"], h["seed"]))
        return out


def run(ctx) -> Dict:
    tr = TrainRun(ctx)
    prog = tr.first_steps()
    prog["replays"] = tr.warm()
    ctx.sync()
    setup_s = time.time() - ctx.t_start
    counters = tr.window()
    memory_peak = ctx.memory_peak()
    ctx.check_modules()
    tr.free()
    with float32():
        ref = tr.reference()
    return {
        "attempted": counters["steps"], "failed": 0,
        "numbers": compare.train_numbers(prog, ref),
        "memory_peak": memory_peak,
        "end_to_end": {"setup_s": setup_s,
                       "train_audio_s_per_s": counters["audio_s"]
                       / counters["window_s"]},
        "counters": counters,
    }
