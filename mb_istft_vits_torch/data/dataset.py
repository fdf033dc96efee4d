"""Training data: filelists, wav loading, the dataset and the bucketed
batcher (counterpart of `mb_istft_vits_tpu/data/dataset.py`; reference
`data_utils.py`).

  - filelist rows `path|text`, or `path|sid|text` when the config has
    speakers (TextAudioLoader / TextAudioSpeakerLoader, data_utils.py:15)
  - text length filter [min_text_len, max_text_len] (data_utils.py:39-40)
  - optional blank interspersal (data_utils.py:89-98)
  - length-bucketed, epoch-seeded batching (DistributedBucketSampler,
    data_utils.py:308-404), padded to static bucket shapes

Batches carry int16 PCM only; the trainer computes the linear
spectrogram on the device (`train.step.prep_batch`). The host-side
`.spec` cache is not ported yet. `data.prefetch` assembles batches on
loader threads and copies them to the card ahead of the step.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
from scipy.io import wavfile

from mb_istft_vits_torch.config import DataConfig
from mb_istft_vits_torch.text import frontend_ids

logger = logging.getLogger(__name__)

# spec-frame bucket edges (reference train_latest.py:79-84)
BOUNDARIES = (32, 300, 400, 500, 600, 700, 800, 900, 1000)


def load_filepaths_and_text(filename: str, split: str = "|",
                            min_cols: int = 2) -> List[List[str]]:
    """Rows of a filelist (reference utils.py:144-147); blank lines and
    lines with fewer than `min_cols` columns are skipped with a warning."""
    rows: List[List[str]] = []
    skipped = 0
    with open(filename, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = line.split(split)
            if len(row) < min_cols:
                skipped += 1
                continue
            rows.append(row)
    if skipped:
        logger.warning("%s: skipped %d malformed line(s) (fewer than %d '|' "
                       "columns)", filename, skipped, min_cols)
    return rows


def load_wav(full_path: str) -> Tuple[np.ndarray, int]:
    """(samples as float32 in the file's integer scale, sampling rate)
    (reference utils.load_wav_to_torch, utils.py:139-141)."""
    sampling_rate, data = wavfile.read(full_path)
    return data.astype(np.float32), sampling_rate


class TextAudioDataset:
    """(text ids, normalized wav[, speaker id]) of a filelist, shuffled
    once by `seed`. `lengths` estimates each row's spectrogram frames from
    its file size (data_utils.py:60)."""

    def __init__(self, filelist: str, cfg: DataConfig, seed: int = 1234):
        self.cfg = cfg
        self.multi_speaker = cfg.n_speakers > 0
        rows = load_filepaths_and_text(
            filelist, min_cols=3 if self.multi_speaker else 2)
        np.random.RandomState(seed).shuffle(rows)
        # the batcher pads text to this static cap, so a row whose ids
        # exceed it is dropped here rather than truncated at batch time
        self.text_id_cap = text_id_cap = (
            cfg.max_text_len * (2 if cfg.add_blank else 1) + 1)
        self.rows: List[List[str]] = []
        self.lengths: List[int] = []
        self._ids: List[np.ndarray] = []
        dropped_long = 0
        for row in rows:
            text = row[2] if self.multi_speaker else row[1]
            if not cfg.min_text_len <= len(text) <= cfg.max_text_len:
                continue
            ids = self.get_text(text)
            if len(ids) > text_id_cap:
                dropped_long += 1
                continue
            self.rows.append(row)
            self._ids.append(ids)
            try:
                self.lengths.append(os.path.getsize(row[0])
                                    // (2 * cfg.hop_length))
            except OSError:
                self.lengths.append(0)
        if dropped_long:
            logger.warning("%s: dropped %d sample(s) whose text expands past "
                           "the %d-id cap", filelist, dropped_long,
                           text_id_cap)

    def __len__(self) -> int:
        return len(self.rows)

    def get_text(self, text: str) -> np.ndarray:
        c = self.cfg
        return np.asarray(frontend_ids(text, c.text_module, c.text_cleaners,
                                       c.add_blank, c.cleaned_text), np.int32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        path = self.rows[index][0]
        audio, sr = load_wav(path)
        if sr != self.cfg.sampling_rate:
            raise ValueError(f"{sr} SR doesn't match target "
                             f"{self.cfg.sampling_rate} SR ({path})")
        item = {"x": self._ids[index],
                "wav": (audio / self.cfg.max_wav_value).astype(np.float32)}
        if self.multi_speaker:
            item["sid"] = int(self.rows[index][1])
        return item


class BucketedBatcher:
    """Static-shape, length-bucketed, epoch-seeded batches (replaces
    DistributedBucketSampler, data_utils.py:308-404, for one process).
    `boundaries` are the spectrogram-frame bucket edges."""

    def __init__(self, dataset: TextAudioDataset, batch_size: int,
                 boundaries: Sequence[int] = BOUNDARIES):
        self.dataset = dataset
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.text_cap = dataset.text_id_cap
        self.buckets: List[List[int]] = [
            [] for _ in range(len(self.boundaries) - 1)]
        for i, length in enumerate(dataset.lengths):
            b = self._bisect(length)
            if b != -1:
                self.buckets[b].append(i)
        # drop empty buckets (data_utils.py:335-338)
        for i in range(len(self.buckets) - 1, 0, -1):
            if not self.buckets[i]:
                self.buckets.pop(i)
                self.boundaries.pop(i + 1)

    def _bisect(self, x: int) -> int:
        for i in range(len(self.boundaries) - 1):
            if self.boundaries[i] < x <= self.boundaries[i + 1]:
                return i
        return -1

    def __len__(self) -> int:
        b = self.batch_size
        return sum(-(-len(bucket) // b) for bucket in self.buckets)

    def epoch_batches(self, epoch: int) -> List[Tuple[int, List[int]]]:
        """(bucket index, sample indices) of every batch of `epoch`."""
        g = np.random.RandomState(epoch)
        batches = []
        for bi, bucket in enumerate(self.buckets):
            ids = list(range(len(bucket)))
            g.shuffle(ids)
            rem = (self.batch_size - len(ids) % self.batch_size
                   ) % self.batch_size
            if rem and ids:
                # fill the last batch by repeating the list
                # (data_utils.py:352)
                ids = ids + ids * (rem // len(ids)) + ids[:rem % len(ids)]
            for j in range(len(ids) // self.batch_size):
                chunk = ids[j * self.batch_size:(j + 1) * self.batch_size]
                batches.append((bi, [bucket[k] for k in chunk]))
        return [batches[i] for i in g.permutation(len(batches))]

    def pad_shape(self, bucket_idx: int) -> Tuple[int, int]:
        """(text ids, spectrogram frames) of every batch of the bucket."""
        return self.text_cap, self.boundaries[bucket_idx + 1]

    def make_batch(self, bucket_idx: int,
                   indices: List[int]) -> Dict[str, np.ndarray]:
        """Collate to the bucket's static shape: x [B, T_x] int32, int16
        wav [B, t_spec * hop + (n_fft - hop), 1] (the sub-hop tail and the
        front end's padding, so the device spectrogram's frames see the
        samples a per-utterance STFT would), lengths [B] int32, and for a
        multi-speaker dataset sid [B] int32."""
        cfg = self.dataset.cfg
        t_x, t_spec = self.pad_shape(bucket_idx)
        t_wav = t_spec * cfg.hop_length + cfg.filter_length - cfg.hop_length
        b = len(indices)
        x = np.zeros((b, t_x), np.int32)
        wav = np.zeros((b, t_wav, 1), np.int16)
        x_lengths, spec_lengths, wav_lengths, sid = (
            np.zeros((b,), np.int32) for _ in range(4))
        for i, idx in enumerate(indices):
            item = self.dataset[idx]
            ids, wv = item["x"], item["wav"]
            lx, lw = min(len(ids), t_x), min(len(wv), t_wav)
            x[i, :lx] = ids[:lx]
            x_lengths[i] = lx
            # int16 sources: the round trip through the float is lossless
            wav[i, :lw, 0] = np.clip(np.rint(wv[:lw] * cfg.max_wav_value),
                                     -32768, 32767).astype(np.int16)
            spec_lengths[i] = min(lw // cfg.hop_length, t_spec)
            wav_lengths[i] = lw
            sid[i] = item.get("sid", 0)
        batch = {"x": x, "x_lengths": x_lengths, "spec_lengths": spec_lengths,
                 "wav": wav, "wav_lengths": wav_lengths}
        if self.dataset.multi_speaker:
            batch["sid"] = sid
        return batch

    def iter_epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        for bucket_idx, indices in self.epoch_batches(epoch):
            yield self.make_batch(bucket_idx, indices)
