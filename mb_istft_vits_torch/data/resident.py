"""The whole corpus held on the card (counterpart of
`mb_istft_vits_tpu/data/resident.py`).

A TTS corpus in int16 PCM is small next to the card's memory (LJSpeech,
about 24 h at 22.05 kHz, is about 3.5 GB with bucket padding; the H100
has 80 GB). So the bucket-padded corpus goes up once at start-up, and
each step's batch is gathered on the card by index: per step only the
[batch] int32 index vector crosses from the host, through pinned memory
and without blocking, in place of the batch's audio. The batches are
those of `BucketedBatcher.make_batch`, bit for bit, in shape, dtype and
content. The reference has no counterpart: its DataLoader
(train_latest.py:85) copies every batch over PCIe every step.

Data parallel (one process per card, as in JAX's multi-host run): every
rank uploads the whole pools to its own card and, of each batch of the
global sequence (`epoch_batches_global`), gathers its own rows, so only
this rank's index vector crosses. `corpus_bytes` is per card, as in JAX.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from mb_istft_vits_torch.data.dataset import BucketedBatcher
from mb_istft_vits_torch.device import resolve_device
from mb_istft_vits_torch.parallel.mesh import mesh_size

# the per-row int32 scalars, one [n, 4] table per pool; sid is 0 for a
# single-speaker corpus and left out of its batches
_SCALARS = ("x_lengths", "spec_lengths", "wav_lengths", "sid")


class DeviceResidentFeeder:
    """Per-bucket pools of the corpus on `device` (CUDA unless the CPU is
    asked for), padded as `make_batch` pads a batch row, so
    `gather(bucket, indices)` gives the host batch bit for bit. Needs the
    dataset's device-spec feed (int16 PCM): host-spec f32 pools would hold
    the spectrograms too, several times the bytes.

    The batcher's `rank` of `num_replicas` picks the rows this process
    gathers. `mesh`, for JAX's callers: the data-parallel devices, one
    per rank (None, or one device, for one process); the pools go to
    `device`, this rank's card."""

    def __init__(self, batcher: BucketedBatcher, mesh=None,
                 logger: Optional[logging.Logger] = None, *,
                 device: Optional[Union[str, torch.device]] = None):
        if not batcher.dataset.device_spec:
            raise ValueError(
                "DeviceResidentFeeder requires device-spec feeding (int16 "
                "PCM pools; host-spec f32 pools would be several times the "
                "bytes)")
        if mesh_size(mesh) not in (1, batcher.num_replicas):
            raise ValueError(
                f"a mesh of {mesh_size(mesh)} devices for "
                f"{batcher.num_replicas} ranks: each rank (process) feeds "
                f"its own card")
        self.batcher = batcher
        self.device = resolve_device(device)
        # dataset index -> row of its bucket's pool
        self._row_of = np.full(len(batcher.dataset), -1, np.int64)
        self._pools: List[Dict[str, torch.Tensor]] = []
        for bi, bucket in enumerate(batcher.buckets):
            self._pools.append({k: torch.from_numpy(v).to(self.device)
                                for k, v in self._build_pool(bi,
                                                             bucket).items()})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the upload has landed
        self.nbytes = sum(t.nbytes for p in self._pools for t in p.values())
        if logger is not None:
            logger.info("device-resident corpus: %d pools, %.2f GB on %s "
                        "(%d utterances)", len(self._pools), self.nbytes / 1e9,
                        self.device, int((self._row_of >= 0).sum()))

    def _build_pool(self, bucket_idx: int,
                    indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """One padded row per utterance at the bucket's static shape, as
        `make_batch` lays out a batch row: x [n, T_x] int32, int16 wav
        [n, t_spec * hop + (n_fft - hop), 1], and the scalars [n, 4]."""
        b = self.batcher
        cfg = b.dataset.cfg
        t_x, t_spec = b.pad_shape(bucket_idx)
        t_wav = t_spec * cfg.hop_length + cfg.filter_length - cfg.hop_length
        n = len(indices)
        x = np.zeros((n, t_x), np.int32)
        wav = np.zeros((n, t_wav, 1), np.int16)
        scalars = np.zeros((n, len(_SCALARS)), np.int32)
        for row, idx in enumerate(indices):
            item = b.dataset[idx]
            ids, wv = item["x"], item["wav"]
            lx, lw = min(len(ids), t_x), min(len(wv), t_wav)
            x[row, :lx] = ids[:lx]
            wav[row, :lw, 0] = np.clip(np.rint(wv[:lw] * cfg.max_wav_value),
                                       -32768, 32767).astype(np.int16)
            scalars[row] = (lx, min(lw // cfg.hop_length, t_spec), lw,
                            item.get("sid", 0))
            self._row_of[idx] = row
        return {"x": x, "wav": wav, "scalars": scalars}

    def _index(self, rows: np.ndarray) -> torch.Tensor:
        idx = torch.from_numpy(rows.astype(np.int32))
        if self.device.type != "cuda":
            return idx
        return idx.pin_memory().to(self.device, non_blocking=True)

    def gather(self, bucket_idx: int, indices: Sequence[int]
               ) -> Dict[str, torch.Tensor]:
        """The batch of `indices` (dataset indices, as `epoch_batches`
        gives them), gathered on the card by `index_select`; only the
        index vector crosses from the host."""
        rows = self._row_of[np.asarray(indices, np.int64)]
        if (rows < 0).any():
            raise KeyError(f"dataset indices not in any bucket pool: "
                           f"{np.asarray(indices)[rows < 0].tolist()}")
        pool, idx = self._pools[bucket_idx], self._index(rows)
        scalars = pool["scalars"].index_select(0, idx)
        batch = {"x": pool["x"].index_select(0, idx),
                 "wav": pool["wav"].index_select(0, idx)}
        keys = _SCALARS if self.batcher.dataset.multi_speaker \
            else _SCALARS[:-1]
        for i, k in enumerate(keys):
            batch[k] = scalars[:, i].contiguous()
        return batch

    def iter_epoch(self, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        """The device-resident `BucketedBatcher.iter_epoch`: of every
        global batch, this rank's rows [r * B:(r + 1) * B] (with one rank,
        the whole batch)."""
        b = self.batcher
        lo = b.rank * b.batch_size
        for bucket_idx, indices in b.epoch_batches_global(epoch):
            yield self.gather(bucket_idx, indices[lo:lo + b.batch_size])

    @staticmethod
    def corpus_bytes(batcher: BucketedBatcher) -> int:
        """The pools' bytes, known before the upload, so the trainer can
        tell whether the corpus fits: int16 wav, int32 ids and 16 bytes of
        scalars a row (JAX `corpus_bytes`)."""
        cfg = batcher.dataset.cfg
        total = 0
        for bi, bucket in enumerate(batcher.buckets):
            t_x, t_spec = batcher.pad_shape(bi)
            t_wav = (t_spec * cfg.hop_length
                     + cfg.filter_length - cfg.hop_length)
            total += len(bucket) * (t_wav * 2 + t_x * 4 + 16)
        return total
