"""Micro-batched serving: coalesce concurrent short synthesize() calls
(the port's copy of `mb_istft_vits_tpu/serve/microbatch.py`).

A single request pays a fixed cost per decode (host dispatch, device
ramp, the copy back) that dominates short utterances; a batch divides it
by its rows. `MicroBatcher` gives callers a blocking, thread-safe
`synthesize(text, ...)` with single-request semantics, while worker
threads coalesce requests that arrive within a small window (default
4 ms) into one `SynthesisModule.synthesize_batch`. A lone request takes
the single-request path, plus at most the wait window.

Two workers hold up to two groups at once. One takes a group at a time
(coalescing, then taking), and while the other waits on its decode it
takes the next group and runs its front end, duration probe and
dispatch, so the next decode is queued on the card right behind the one
running and the card does not wait for the host between them. Both queue
on the same stream, so probes, decodes and copies run in the order they
were queued: the second group's probe waits for the decode ahead of it.
A third worker would only queue a third probe behind two decodes.

The module is called from the worker threads only; it names its device
explicitly, so a thread's current CUDA device does not matter, and it is
safe for two callers (`infer.synthesis`).

While a profiler runs, the front end records three spans
(`utils.observability.span`): `serve.queued`, a request from its enqueue
to a worker taking it into a group; `serve.coalesce`, the taking worker
from seeing a first request to taking the group (the wait on an empty
queue is not one); `serve.decode`, the group taken to every waiter's
answer set, the error path included. The two workers' `serve.decode`
spans overlap.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from mb_istft_vits_torch.utils.observability import now_ns, record_span, span

# worker threads: one decoding while the other readies the next group
WORKERS = 2


@dataclass
class _Pending:
    text: str
    sid: Optional[int]
    done: threading.Event = field(default_factory=threading.Event)
    audio: Optional[np.ndarray] = None
    timings: Optional[dict] = None
    error: Optional[BaseException] = None
    enqueued_ns: int = field(default_factory=now_ns)


class MicroBatcher:
    """Thread-safe coalescing front-end over a SynthesisModule.

    Requests sharing one knob tuple (noise_scale, length_scale,
    noise_scale_w, cleaned, seed) coalesce; mixed-knob traffic splits
    into per-tuple dispatches (production traffic overwhelmingly uses
    defaults, so the common case is one batch). ``max_batch`` bounds a
    decode at the largest batch bucket; ``max_wait_ms`` is
    the coalescing window a FIRST request waits for company.
    """

    def __init__(self, module, max_batch: int = 8,
                 max_wait_ms: float = 4.0):
        self.module = module
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1000.0
        self._lock = threading.Condition()
        self._queues: dict = {}  # knob tuple -> list[_Pending]
        # held by the worker taking a group: one coalescing window at a time
        self._taking = threading.Lock()
        self._running = False
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._running:
                return
            self._running = True
            self._threads = [threading.Thread(target=self._worker,
                                              daemon=True)
                             for _ in range(WORKERS)]
            for th in self._threads:
                th.start()

    def stop(self) -> None:
        with self._lock:
            self._running = False
            self._lock.notify_all()
        for th in self._threads:
            th.join(timeout=5.0)
        self._threads = []

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- client API ----------------------------------------------------
    def synthesize(
        self,
        text: str,
        sid: Optional[int] = None,
        noise_scale: float = 0.667,
        length_scale: float = 1.0,
        noise_scale_w: float = 0.8,
        cleaned: Optional[bool] = None,
        seed: int = 0,
        timeout: Optional[float] = 60.0,
    ):
        """Blocking single-utterance call with the same signature shape
        as SynthesisModule.synthesize; returns (audio, timings). timings
        carries ``batched`` — how many requests shared the dispatch — and
        for a coalesced call ``batch_order`` and ``batch_sids``, the texts
        and speakers of the batch's rows. Requests of different speakers
        share a batch; each row keeps its own."""
        if not self._running:
            self.start()
        req = _Pending(text, sid)
        key = (float(noise_scale), float(length_scale),
               float(noise_scale_w), cleaned, int(seed))
        with self._lock:
            self._queues.setdefault(key, []).append(req)
            self._lock.notify_all()
        if not req.done.wait(timeout):
            raise TimeoutError("micro-batch synthesis timed out")
        if req.error is not None:
            raise req.error
        return req.audio, req.timings

    # -- worker --------------------------------------------------------
    def _take_group(self):
        """Pop up to max_batch requests sharing one knob tuple, after
        giving the first arrival max_wait seconds of company time."""
        with self._lock:
            while self._running and not any(self._queues.values()):
                self._lock.wait(timeout=0.1)
            if not self._running:
                return None, []
            with span("serve.coalesce"):
                deadline = time.perf_counter() + self.max_wait
                biggest = None
                while self._running:
                    biggest = max((q for q in self._queues.values() if q),
                                  key=len, default=None)
                    if biggest is None:
                        return None, []
                    if (len(biggest) >= self.max_batch
                            or time.perf_counter() >= deadline):
                        break
                    self._lock.wait(timeout=max(
                        deadline - time.perf_counter(), 1e-4))
                if biggest is None:
                    return None, []
                for key, q in self._queues.items():
                    if q is biggest:
                        take = q[: self.max_batch]
                        del q[: self.max_batch]
                        if not q:  # unique-knob keys must not accumulate
                            del self._queues[key]
                        return key, take
                return None, []

    def _worker(self) -> None:
        while True:
            with self._taking:
                key, group = self._take_group()
            if not group:
                if not self._running:
                    return
                continue
            ns, ls, nsw, cleaned, seed = key
            with span("serve.decode") as taken:
                if taken is not None:
                    for g in group:
                        record_span("serve.queued", g.enqueued_ns, taken)
                self._decode(group, ns, ls, nsw, cleaned, seed)

    def _decode(self, group, ns, ls, nsw, cleaned, seed) -> None:
        """One decode of `group`: each waiter's audio and timings, or the
        error; every waiter's `done` is set."""
        try:
            if len(group) == 1:
                # no company arrived: single-call path (lowest latency for
                # the lone-request case)
                audio, t = self.module.synthesize(
                    group[0].text, group[0].sid, noise_scale=ns,
                    length_scale=ls, noise_scale_w=nsw, cleaned=cleaned,
                    seed=seed)
                t = dict(t, batched=1)
                group[0].audio, group[0].timings = audio, t
            else:
                audios, t = self.module.synthesize_batch(
                    [g.text for g in group], sids=[g.sid for g in group],
                    noise_scale=ns, length_scale=ls, noise_scale_w=nsw,
                    cleaned=cleaned, seed=seed)
                t = dict(t, batched=len(group),
                         batch_order=[g.text for g in group],
                         batch_sids=[g.sid for g in group])
                for g, a in zip(group, audios):
                    g.audio, g.timings = a, t
        except BaseException as e:  # surface to EVERY waiter
            for g in group:
                g.error = e
        finally:
            for g in group:
                g.done.set()
