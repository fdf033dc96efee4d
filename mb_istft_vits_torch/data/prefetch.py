"""Batch prefetch (counterpart of `mb_istft_vits_tpu/data/prefetch.py`;
the reference's `DataLoader(num_workers=8, pin_memory=True)`,
train_latest.py:85).

`PrefetchIterator` assembles an epoch's batches (wav read, host
spectrogram or its `.spec.npy` cache, pad, int16) on worker threads while
the card runs the step; the work is numpy and the native loader's C calls
(ctypes), which release the interpreter lock. An in-order window of at
most `prefetch_depth` batches bounds host memory and keeps the batcher's
epoch-seeded order.

`device_prefetch` copies batch i+1.. to the card while step i runs: each
host batch, every key of it (`spec` too on the host-spec feed), goes
through pinned memory by a non-blocking copy on a side stream, and the
consumer's stream waits on that copy's event before the batch is used.
At most `depth` batches are in flight.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from mb_istft_vits_torch.data.dataset import BucketedBatcher


class PrefetchIterator:
    """The batches of one epoch, assembled by `num_workers` threads ahead
    of the consumer, in the batcher's epoch-seeded order."""

    def __init__(self, batcher: BucketedBatcher, epoch: int,
                 num_workers: int = 8, prefetch_depth: Optional[int] = None):
        self._batcher = batcher
        self._plan: List[Tuple[int, List[int]]] = batcher.epoch_batches(epoch)
        self._num_workers = num_workers
        # the window defaults to the worker count: a smaller one would
        # leave workers idle
        self._depth = max(1, prefetch_depth or num_workers)

    def __len__(self) -> int:
        return len(self._plan)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # a pool per iteration: an early break (max steps, SIGTERM) shuts
        # it down through the generator's finally, and a later iteration
        # gets a fresh one
        pool = ThreadPoolExecutor(max_workers=self._num_workers,
                                  thread_name_prefix="loader")
        futures: collections.deque = collections.deque()
        plan = iter(self._plan)
        try:
            for bucket, indices in plan:
                futures.append(pool.submit(self._batcher.make_batch, bucket,
                                           indices))
                if len(futures) >= self._depth:
                    break
            while futures:
                batch = futures.popleft().result()
                nxt = next(plan, None)
                if nxt is not None:
                    futures.append(pool.submit(self._batcher.make_batch,
                                               *nxt))
                yield batch
        finally:
            pool.shutdown(wait=False, cancel_futures=True)


def prefetch_epoch(batcher: BucketedBatcher, epoch: int,
                   num_workers: int = 8,
                   prefetch_depth: Optional[int] = None) -> PrefetchIterator:
    """The epoch's batches with `num_workers` loader threads and a bounded
    prefetch window."""
    return PrefetchIterator(batcher, epoch, num_workers, prefetch_depth)


def device_prefetch(batches: Iterable[Dict[str, np.ndarray]],
                    device: torch.device, depth: int = 2
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Host batches -> the same batches as tensors on `device`. On CUDA the
    copies run `depth` batches ahead on a side stream (pinned memory,
    non-blocking) and the current stream waits on each copy's event
    before its batch is handed out; elsewhere the copy is in line."""
    it = iter(batches)
    if device.type != "cuda":
        for host in it:
            yield {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        return
    side = torch.cuda.Stream(device)
    queue: collections.deque = collections.deque()

    def put(host):
        pinned = {k: torch.from_numpy(v).pin_memory() for k, v in host.items()}
        # the copy and its event on `device`, whichever card is current
        with torch.cuda.device(device), torch.cuda.stream(side):
            on_card = {k: v.to(device, non_blocking=True)
                       for k, v in pinned.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        queue.append((on_card, ready))

    for host in it:
        put(host)
        if len(queue) >= max(1, depth):
            break
    while queue:
        on_card, ready = queue.popleft()
        current = torch.cuda.current_stream(device)
        current.wait_event(ready)
        for v in on_card.values():
            # made on the side stream, used on this one: the allocator
            # must not hand the memory out again before this stream is done
            v.record_stream(current)
        host = next(it, None)
        if host is not None:
            put(host)
        yield on_card
