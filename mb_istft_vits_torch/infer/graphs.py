"""CUDA graphs of the serving programs, one per program and input
signature (the port's counterpart of the JAX package's compiled serving
programs: `_build_*` under `functools.lru_cache` in `infer/synthesis.py`,
keyed per input signature as `utils/aot.py:_call_signature` keys them).

`GraphCache.run(key, fn, args, device)` runs fn(*args) as a CUDA graph.
The first call at a key and input signature (each input's shape and
dtype, or None) runs fn eagerly on a side stream `WARMUP_ITERS` times,
which sets up what a capture cannot (cuDNN's algorithm choice, cuFFT's
plans, the constants `device.device_constant` keeps), then captures it
with static input buffers; that is where `jax.jit` compiles. Every call,
the first included, copies its inputs into the static buffers, replays the
graph and returns copies of its outputs: a replay's outputs never alias a
buffer that a later replay writes (two mesh positions on one card share
one replica, so one graph, within one batch).

All graphs of one cache share one memory pool
(`torch.cuda.graph_pool_handle()`). Their replays are queued on the
caller's current stream, in order, under the cache's lock, so no two of
them run at once. Captures run under a process-wide lock with
`capture_error_mode="thread_local"`: the micro-batcher calls the serving
module from its worker thread while other threads may use the card. A
capture or replay that fails raises; nothing falls back to eager.

On a device without graphs (the CPU) fn runs directly, and its keys are
kept all the same (`keys()`), so what a card would capture shows there.

A graph cannot be written to disk, so `aot_cache_dir` has no use here.
"""

from __future__ import annotations

import threading
import time
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

# eager runs on a side stream before a capture
WARMUP_ITERS = 2
_CAPTURE_LOCK = threading.Lock()


def signature(args: Sequence[Optional[torch.Tensor]]) -> tuple:
    """(shape, dtype) of each input, None for an absent one."""
    sig = []
    for a in args:
        if a is None:
            sig.append(None)
        elif isinstance(a, torch.Tensor):
            sig.append((tuple(a.shape), a.dtype))
        else:
            raise TypeError(f"a graph input is a tensor or None, not "
                            f"{type(a).__name__}: pass options as part of "
                            "the key")
    return tuple(sig)


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: List[Optional[torch.Tensor]]  # the static input buffers
    outputs: Tuple[torch.Tensor, ...]  # written by every replay
    single: bool  # fn returned one tensor, not a tuple


class KnobCache:
    """Knob values (noise and length scales) as program inputs: 0-dim
    float32 tensors kept per (value, device) (JAX `_dev_scalar`), so a
    request uploads nothing for them and a graph reads them from where it
    was captured. Cleared past `LIMIT` values."""

    LIMIT = 256

    def __init__(self):
        self._knobs: Dict[Tuple[float, torch.device], torch.Tensor] = {}

    def __call__(self, v: float, device: torch.device) -> torch.Tensor:
        key = (float(v), torch.device(device))
        hit = self._knobs.get(key)
        if hit is None:
            if len(self._knobs) > self.LIMIT:
                self._knobs.clear()
            hit = self._knobs[key] = torch.tensor(
                float(v), dtype=torch.float32, device=device)
        return hit


class GraphCache:
    """The captured graphs of one serving module. `captures`, `replays`
    and `capture_seconds` ({key: seconds}) count what it did."""

    def __init__(self):
        self.pool = None  # made at the first capture (needs a card)
        self._graphs: Dict[tuple, Optional[_Graph]] = {}
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = 0
        self.capture_seconds: Dict[tuple, float] = {}

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self):
        return list(self._graphs)

    def run(self, key: tuple, fn: Callable, args: Sequence,
            device: torch.device):
        """fn(*args) as the graph of (key, device, signature(args)); fn
        returns a tensor or a tuple of tensors, and so does this, as
        copies. Every tensor input must be on `device`. Off CUDA, fn(*args)
        itself."""
        full = (*key, device, signature(args))
        if device.type != "cuda":
            self._graphs[full] = None
            with torch.no_grad():
                return fn(*args)
        for a in args:
            if a is not None and a.device != device:
                raise ValueError(f"graph {key}: an input is on {a.device}, "
                                 f"not {device}")
        with self._lock, torch.cuda.device(device):
            g = self._graphs.get(full)
            if g is None:
                g = self._graphs[full] = self._capture(full, fn, args,
                                                       device)
            for buf, a in zip(g.inputs, args):
                if buf is not None:
                    buf.copy_(a, non_blocking=True)
            g.graph.replay()
            self.replays += 1
            out = tuple(o.clone() for o in g.outputs)
        return out[0] if g.single else out

    def _capture(self, full: tuple, fn: Callable, args: Sequence,
                 device: torch.device) -> _Graph:
        t0 = time.perf_counter()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        inputs = [None if a is None else a.detach().clone() for a in args]
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.no_grad(), torch.cuda.stream(side):
            for _ in range(WARMUP_ITERS):
                fn(*inputs)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # torch.cuda.graph's context would also collect garbage and empty
        # the allocator's cache at every capture
        with _CAPTURE_LOCK, torch.no_grad(), torch.cuda.stream(side):
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                out = fn(*inputs)
            except BaseException:
                end_failed_capture(graph)
                raise
            graph.capture_end()
        current.wait_stream(side)
        single = isinstance(out, torch.Tensor)
        outputs: Tuple[torch.Tensor, ...] = (out,) if single else tuple(out)
        self.captures += 1
        self.capture_seconds[full] = time.perf_counter() - t0
        return _Graph(graph, inputs, outputs, single)

    def pool_bytes(self) -> Optional[int]:
        """Bytes the caching allocator holds in this cache's pool, over
        every device (None before the first capture)."""
        return pool_bytes(self.pool)


def end_failed_capture(graph) -> None:
    """End the capture of `graph` after its body raised (the body's error
    says why). A capture the error invalidated fails to end, and torch
    then leaves the current device's default CUDA generator in its
    capture mode, where every later random op outside a capture fails; so
    its state is set anew, at the seed and offset it had before the
    capture (a capture does not advance them)."""
    try:
        graph.capture_end()
    except RuntimeError:
        gen = torch.cuda.default_generators[torch.cuda.current_device()]
        gen.graphsafe_set_state(gen.clone_state())


def pool_bytes(pool) -> Optional[int]:
    """Bytes the caching allocator holds in the graph memory pool `pool`
    (`torch.cuda.graph_pool_handle()`), over every device; None for no
    pool."""
    if pool is None:
        return None
    pool = tuple(pool)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == pool)
