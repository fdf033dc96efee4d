"""CUDA graphs of the training step, one set per batch signature (the
port's counterpart of the JAX package's two jitted train programs,
`d_step` and `g_step` of `train/step.py:make_train_step`, compiled once
per bucket shape: "2 per bucket", `train.py:262-266`; its data-parallel
and 2-D (data x model) steps are the same two programs, with the
collectives that XLA inserts inside them).

`TrainGraphs.step(state, batch, draws)` is one real training step. At a
new key, the batch's signature (each step input's shape and dtype, or
None: "x", "x_lengths", "wav" int16 or float, "spec" present or not,
"spec_lengths", "sid", and the draws) with the model variant, `fp16_run`,
`mas_force`, the device, the world size, the group's backend and the
ranks the leaves are sharded over (`TrainState.n_model`), the
first `WARMUP_ITERS` calls run the eager body (`train.step.step_body`) on
a side stream, each the step it is: a training warm-up changes the
weights, so it cannot be run and thrown away, and it sets up what a
capture cannot (cuDNN's algorithm choice, cuFFT's plans, the mel basis,
the MAS library's build, the gradients, the flat gradient buffers and
AdamW's moments). The next call captures the step on static copies of
its inputs and runs it; every later call at the key copies its inputs
into those buffers and replays. Every call is one step, so
`state.step`, the draws (`train.step.draw_step`, made before the step
from the step's generator; a data-parallel rank draws its own rows) and
the lr schedule (`write_lr`, filled into the optimizers' lr tensors
before the step) advance as eagerly.

The step is the stages of `train.step.step_stages`. A plain state's
three are one graph. A data-parallel state's three (a world above 1, or
a process group of one rank) and a sharded state's five are a graph
each, from one collective to the next: the collectives
(`train.step.collectives`: the gradient all-reduces, and a sharded
state's all-gathers of its shards) run eagerly between the graphs, on
the caller's stream, in place on the flat buffers (`train.step.drive`,
which the warm-ups, the capture and the replays all go through). The
capture runs the step so: it captures stage 1 and replays it, runs
collective 1, captures stage 2, and so on. Over NCCL nothing waits on
the host; over gloo each collective syncs, as eagerly. Dropout draws
from torch's default CUDA generator, whose offset each graph's replay
advances by what that graph drew.

Nothing that outlives a step lives in a graph's memory pool: the
gradients and their flat buffers, the shards' gradients, AdamW's
moments, step counts and lr are made by the eager warm-up steps, and the
shards' send and receive buffers by `parallel.tp.shard_train_state_tp`,
outside any pool; each graph zeroes the gradients in place and writes
the same tensors. So all of a state's graphs share one pool, the stages
of a step replayed in their order, one step at a time, on the caller's
stream. A capture in which a gradient first appears, or a parameter, a
shard or a flat buffer is first made or moved, raises. The metrics
leave the last graph as one stacked float32 buffer, copied out at each
replay (a later replay overwrites it) and split into 0-d tensors of
their eager dtypes.

`train.step.train_step` routes every state here. On a device without
graphs (the CPU) the body runs directly and its key is kept all the same
(`keys()`). A capture or replay that fails raises; nothing falls back to
eager.

Whatever replaces or rewrites the tensors a graph reads must drop the
state's graphs (`clear`): `train.checkpoint.resume` does when it loads
optimizer state; loading weights alone (a sharded state's shards
refreshed from them) and `snap_to_epoch` write in place.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mb_istft_vits_torch.infer.graphs import (_CAPTURE_LOCK, WARMUP_ITERS,
                                              end_failed_capture,
                                              pool_bytes, signature)
from mb_istft_vits_torch.ops import mas
from mb_istft_vits_torch.train.step import (StepDraws, TrainState, drive,
                                            draw_step, optimizer_params,
                                            step_body, step_stages,
                                            train_step_eager, write_lr)

# the batch entries the step reads, in the graph's input order
STEP_KEYS = ("x", "x_lengths", "wav", "spec", "spec_lengths", "sid")


def routed(state: TrainState) -> bool:
    """Whether `train_step` steps `state` through `TrainGraphs`: every
    state does."""
    return True


def _held(state: TrainState) -> Tuple[List[torch.Tensor], List[int]]:
    """What a capture must find made and keeps in place: every parameter
    and every tensor the optimizers update (with the gradients they have),
    and the addresses of those and of every flat buffer."""
    params = [p for net in (state.net_g, state.net_d)
              for p in net.parameters()]
    params += [p for optim in (state.optim_g, state.optim_d)
               for p in optimizer_params(optim)]
    buffers = [state.grad_buffers[k] for k in sorted(state.grad_buffers)]
    buffers += [b for k in sorted(state.shards)
                for b in (state.shards[k].send, state.shards[k].recv)]
    return params, [t.data_ptr() for t in params + buffers]


def _args(batch: Dict[str, torch.Tensor], draws: Optional[StepDraws]
          ) -> List[Optional[torch.Tensor]]:
    return ([batch.get(k) for k in STEP_KEYS]
            + list(draws if draws is not None else StepDraws(None, None)))


def _unpack(args: Sequence[Optional[torch.Tensor]]
            ) -> Tuple[Dict[str, torch.Tensor], StepDraws]:
    n = len(STEP_KEYS)
    return ({k: a for k, a in zip(STEP_KEYS, args[:n]) if a is not None},
            StepDraws(*args[n:]))


class _TrainGraph:
    """One captured step: a graph a stage, the static input buffers, the
    stacked metrics the last graph writes (names and eager dtypes), and
    the MAS launches of the capture, which each replay adds
    (`ops.mas.add_launches`)."""

    def __init__(self, graphs: Sequence, inputs: List[Optional[torch.Tensor]],
                 metrics: torch.Tensor, names: Tuple[str, ...],
                 dtypes: Tuple[torch.dtype, ...], launches: Dict[str, int]):
        self.graphs, self.inputs, self.metrics = list(graphs), inputs, metrics
        self.names, self.dtypes, self.launches = names, dtypes, launches

    def replay(self, state: TrainState,
               args: Sequence[Optional[torch.Tensor]]
               ) -> Dict[str, torch.Tensor]:
        """The step on `args`: copied into the input buffers, then the
        stages' graphs with the state's collectives between (`drive`)."""
        for buf, a in zip(self.inputs, args):
            if buf is not None:
                buf.copy_(a, non_blocking=True)
        drive(state, lambda i: self.graphs[i].replay(), len(self.graphs))
        mas.add_launches(self.launches)
        return self.read()

    def read(self) -> Dict[str, torch.Tensor]:
        """The last step's metrics, copied out of the graph's buffer."""
        flat = self.metrics.clone()
        return {k: v.to(dt) for k, v, dt in
                zip(self.names, flat.unbind(), self.dtypes)}


class TrainGraphs:
    """The step graphs of one `TrainState`. `captures`, `replays`,
    `eager_steps` (the warm-ups), `capture_seconds`,
    `pool_bytes_at_capture` and `graphs_a_step` ({key: value})
    count what it did."""

    def __init__(self):
        self.pool = None  # made at the first capture (needs a card)
        self._side: Optional[torch.cuda.Stream] = None
        self._graphs: Dict[tuple, _TrainGraph] = {}
        self._warm: Dict[tuple, int] = {}  # eager steps taken at a key
        self.captures = 0
        self.replays = 0
        self.eager_steps = 0
        self.capture_seconds: Dict[tuple, float] = {}
        self.pool_bytes_at_capture: Dict[tuple, Optional[int]] = {}
        self.graphs_a_step: Dict[tuple, int] = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self) -> List[tuple]:
        """Every key stepped at: captured on a card, run directly on the
        CPU."""
        return list(self._warm)

    def clear(self) -> None:
        """Drop every graph (and the warm-up counts): the next steps warm
        up and capture again, into a new pool (the allocator releases a
        pool once no graph holds it, and its handle cannot be reused)."""
        self._graphs.clear()
        self._warm.clear()
        self.pool = None

    @staticmethod
    def key(state: TrainState, args: Sequence[Optional[torch.Tensor]]
            ) -> tuple:
        m = state.cfg.model
        group = state.group
        return ("train", type(state.net_g.dec).__name__, m.use_sdp,
                m.n_speakers, state.cfg.train.fp16_run, state.mas_force,
                state.device, state.world,
                None if group is None else dist.get_backend(group),
                state.n_model, signature(args))

    def pool_bytes(self) -> Optional[int]:
        """Bytes the caching allocator holds in the graphs' pool (None
        before the first capture)."""
        return pool_bytes(self.pool)

    def step(self, state: TrainState, batch: Dict[str, torch.Tensor],
             draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
        """One training step of `state` on `batch` (`train_step`'s
        contract); advances `state.step`."""
        dev = state.device
        if dev.type != "cuda":
            self._warm[self.key(state, _args(batch, draws))] = 0
            return train_step_eager(state, batch, draws)
        if draws is None:
            draws = draw_step(state, batch)
        args = _args(batch, draws)
        for a in args:
            if a is not None and a.device != dev:
                raise ValueError(f"a step input is on {a.device}, not {dev}")
        key = self.key(state, args)
        write_lr(state)
        with torch.cuda.device(dev):
            metrics = self._run(key, state, args)
        metrics["learning_rate"] = torch.tensor(state.learning_rate())
        state.step += 1
        return metrics

    def _run(self, key, state, args) -> Dict[str, torch.Tensor]:
        g = self._graphs.get(key)
        if g is None:
            warm = self._warm.get(key, 0)
            if warm < WARMUP_ITERS:
                self._warm[key] = warm + 1
                return self._eager(state, args)
            g = self._graphs[key] = self._capture(key, state, args)
            metrics = g.read()
        else:
            metrics = g.replay(state, args)
        self.replays += 1
        return metrics

    def _side_stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream()
        return self._side

    def _eager(self, state, args) -> Dict[str, torch.Tensor]:
        """A warm-up step: the body on the side stream the captures use."""
        current, side = torch.cuda.current_stream(), self._side_stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            metrics = step_body(state, *_unpack(args))
        current.wait_stream(side)
        for v in metrics.values():  # made on the side stream, read on ours
            v.record_stream(current)
        self.eager_steps += 1
        return metrics

    def _capture(self, key, state, args) -> _TrainGraph:
        """Capture each stage on static copies of `args` and run it at
        once (replay), the collectives between, so that this call is the
        step it is."""
        t0 = time.perf_counter()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        inputs = [None if a is None else a.detach().clone() for a in args]
        params, addresses = _held(state)
        without_grad = [p.grad is None for p in params]
        stages = step_stages(state, *_unpack(inputs))
        # a graph from one collective to the next: with none, one graph
        parts = ([stages] if state.group is None
                 else [[stage] for stage in stages])
        graphs, launches, flat = [], {}, []

        def capture(i):
            graph = torch.cuda.CUDAGraph()
            with mas.captured_launches() as counted:
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    for stage in parts[i]:
                        out = stage()
                    if out is not None:  # the metrics, stacked in the graph
                        flat.append((tuple(out), tuple(
                            v.dtype for v in out.values()), torch.stack(
                                [v.float().reshape(()) for v in
                                 out.values()])))
                except BaseException:
                    end_failed_capture(graph)
                    raise
                graph.capture_end()
            graph.replay()
            mas.add_launches(counted)
            for k, v in counted.items():
                launches[k] = launches.get(k, 0) + v
            graphs.append(graph)

        current, side = torch.cuda.current_stream(), self._side_stream()
        side.wait_stream(current)
        # the warm-up steps leave the allocator's cache full of blocks the
        # graph's pool cannot take, and a capture cannot free them: at
        # batch 64 the capture then runs out of memory. So the cache is
        # emptied first, as torch.cuda.graph does
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with _CAPTURE_LOCK, torch.cuda.stream(side):
            drive(state, capture, len(parts))
        current.wait_stream(side)
        appeared = sum(1 for p, none in zip(params, without_grad)
                       if none and p.grad is not None)
        if appeared or _held(state)[1] != addresses:
            raise RuntimeError(
                f"train graph {key[:-1]}: {appeared} gradient(s), or a "
                "parameter, shard or flat buffer, first allocated or moved "
                "inside the capture, in the graphs' pool; the eager warm-up "
                "steps and the sharding must make them all")
        (names, dtypes, metrics), = flat
        self.captures += 1
        self.capture_seconds[key] = time.perf_counter() - t0
        self.pool_bytes_at_capture[key] = self.pool_bytes()
        self.graphs_a_step.pop(key, None)  # the newest capture last
        self.graphs_a_step[key] = len(graphs)
        return _TrainGraph(graphs, inputs, metrics, names, dtypes, launches)
