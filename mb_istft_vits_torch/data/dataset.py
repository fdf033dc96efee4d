"""Training data: filelists, wav loading, host spectrograms, the dataset
and the bucketed batcher (counterpart of
`mb_istft_vits_tpu/data/dataset.py`; reference `data_utils.py`).

  - filelist rows `path|text`, or `path|sid|text` when the config has
    speakers (TextAudioLoader / TextAudioSpeakerLoader, data_utils.py:15)
  - text length filter [min_text_len, max_text_len] (data_utils.py:39-40)
  - optional blank interspersal (data_utils.py:89-98)
  - wav -> linear spectrogram with a disk cache beside the wav
    (data_utils.py:78-86; `.spec.npy` here in place of `.spec.pt`)
  - length-bucketed, epoch-seeded, rank-strided batching
    (DistributedBucketSampler, data_utils.py:308-404), padded to static
    bucket shapes

Two feeds, as in the JAX package. `device_spec=True` ships int16 PCM
only, and the trainer computes the linear spectrogram on the card
(`train.step.prep_batch`). `device_spec=False` (the default, as in JAX)
is the reference pipeline: each item carries its host spectrogram, read
from or written to the `.spec.npy` cache, and a batch carries `spec`
beside an f32 wav. Wavs are read and host spectrograms computed by the
native library (`data.native_audio`, C++ with OpenMP) when it is built,
else by scipy and numpy; `loader_paths` counts which path each call took,
and a fall back is logged once at WARNING. `data.prefetch` assembles
batches on loader threads and copies them to the card ahead of the step;
`data.resident` holds the whole corpus on the card instead.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from scipy.io import wavfile

from mb_istft_vits_torch.config import DataConfig
from mb_istft_vits_torch.data import native_audio
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


# how many calls took each loader path: "wav_native" / "wav_scipy" and
# "spec_native" / "spec_numpy"
loader_paths: collections.Counter = collections.Counter()
_paths_lock = threading.Lock()


def _took(path: str, fallback_reason: Optional[str] = None) -> None:
    """Count a call of `path`; the first fall back of each kind is logged
    at WARNING (the native path once at INFO)."""
    with _paths_lock:
        first = loader_paths[path] == 0
        loader_paths[path] += 1
    if first and fallback_reason is None:
        logger.info("loader: %s", path)
    elif first:
        logger.warning("loader: %s (%s)", path, fallback_reason)


def load_wav(full_path: str) -> Tuple[np.ndarray, int]:
    """(samples as float32 in the file's integer scale, sampling rate)
    (reference utils.load_wav_to_torch, utils.py:139-141): the native
    reader first, scipy for what it does not handle."""
    r = native_audio.load_wav(full_path)
    if r is not None:
        _took("wav_native")
        return r
    _took("wav_scipy", "the native reader is unavailable or does not "
                       "handle this container")
    sampling_rate, data = wavfile.read(full_path)
    return data.astype(np.float32), sampling_rate


def spectrogram_numpy(audio_norm: np.ndarray, n_fft: int, hop: int,
                      win: int) -> np.ndarray:
    """The host spectrogram's plain version: [frames, n_fft // 2 + 1] of
    audio_norm [T] with the training front end's zero padding, numpy FFT
    (JAX `_spectrogram_host`'s fall back)."""
    p = (n_fft - hop) // 2
    y = np.pad(audio_norm, (p, p))
    frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
    window = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win))
    if win < n_fft:
        left = (n_fft - win) // 2
        window = np.pad(window, (left, n_fft - win - left))
    return np.abs(
        np.fft.rfft(y[idx] * window[None, :], axis=-1)).astype(np.float32)


def _spectrogram_host(audio_norm: np.ndarray, n_fft: int, hop: int,
                      win: int) -> np.ndarray:
    """Host linear spectrogram [frames, bins] for the loader: the native
    C++/OpenMP FFT, numpy where it does not apply (the reference's loader
    likewise runs on CPU DataLoader workers, train_latest.py:85)."""
    spec = native_audio.spectrogram(audio_norm, n_fft, hop, win)
    if spec is not None:
        _took("spec_native")
        return spec
    _took("spec_numpy", "the native spectrogram is unavailable or n_fft is "
                        "not a power of two")
    return spectrogram_numpy(audio_norm, n_fft, hop, win)


class TextAudioDataset:
    """(text ids, spec, normalized wav[, speaker id]) of a filelist,
    shuffled once by `seed`. `lengths` estimates each row's spectrogram
    frames from its file size (data_utils.py:60). Rows whose ids exceed
    `text_id_cap` (default: max_text_len, doubled with blanks, + 1) are
    dropped, since the batcher pads text to that cap.

    device_spec=True: items carry no spec, and the trainer computes it on
    the card from int16 PCM. device_spec=False (the default, as in the
    JAX package): items carry `spec` [F, bins] f32 from a `.spec.npy`
    beside the wav, written on first use."""

    def __init__(self, filelist: str, cfg: DataConfig, seed: int = 1234,
                 text_id_cap: Optional[int] = None,
                 device_spec: bool = False):
        self.device_spec = device_spec
        self.cfg = cfg
        self.multi_speaker = cfg.n_speakers > 0
        rows = load_filepaths_and_text(
            filelist, min_cols=3 if self.multi_speaker else 2)
        np.random.RandomState(seed).shuffle(rows)
        if text_id_cap is None:
            text_id_cap = cfg.max_text_len * (2 if cfg.add_blank else 1) + 1
        self.text_id_cap = text_id_cap
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

    def get_audio(self, filename: str
                  ) -> Tuple[Optional[np.ndarray], np.ndarray]:
        """(spec [F, bins] f32 or None with device_spec, normalized f32
        wav [T])."""
        cfg = self.cfg
        audio, sr = load_wav(filename)
        if sr != cfg.sampling_rate:
            raise ValueError(f"{sr} SR doesn't match target "
                             f"{cfg.sampling_rate} SR ({filename})")
        audio_norm = (audio / cfg.max_wav_value).astype(np.float32)
        if self.device_spec:
            return None, audio_norm
        # splitext: replace(".wav", ...) would rewrite a ".wav" in a
        # directory name and leave other extensions alone
        spec_filename = os.path.splitext(filename)[0] + ".spec.npy"
        if os.path.exists(spec_filename):
            spec = np.load(spec_filename)
        else:
            spec = _spectrogram_host(audio_norm, cfg.filter_length,
                                     cfg.hop_length, cfg.win_length)
            try:
                # atomic: a loader thread (bucket padding repeats indices)
                # or another process must never read a half-written cache;
                # the temp name is unique per process AND per thread, as
                # the loader threads share one pid
                tmp = (f"{spec_filename}.tmp."
                       f"{os.getpid()}.{threading.get_ident()}")
                with open(tmp, "wb") as f:
                    np.save(f, spec)
                os.replace(tmp, spec_filename)
            except OSError:
                pass
        return spec.astype(np.float32), audio_norm

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        row = self.rows[index]
        spec, wav = self.get_audio(row[0])
        item = {"x": self._ids[index], "wav": wav}
        if spec is not None:
            item["spec"] = spec
        if self.multi_speaker:
            item["sid"] = int(row[1])
        return item


class BucketedBatcher:
    """Static-shape, length-bucketed, epoch-seeded, rank-strided batches
    (replaces DistributedBucketSampler, data_utils.py:308-404).
    `boundaries` are the spectrogram-frame bucket edges; rank `rank` of
    `num_replicas` takes every num_replicas-th id of each bucket."""

    def __init__(self, dataset: TextAudioDataset, batch_size: int,
                 boundaries: Sequence[int] = BOUNDARIES,
                 num_replicas: int = 1, rank: int = 0, shuffle: bool = True,
                 max_text_frames: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        # the dataset drops rows past its cap, so padding to it is lossless
        self.text_cap = max_text_frames or dataset.text_id_cap
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
        """Batches an epoch, per rank."""
        tb = self.num_replicas * self.batch_size
        return sum(-(-len(bucket) // tb) for bucket in self.buckets)

    def epoch_batches(self, epoch: int) -> List[Tuple[int, List[int]]]:
        """(bucket index, sample indices) of every batch of `epoch` on this
        rank."""
        g = np.random.RandomState(epoch)
        tb = self.num_replicas * self.batch_size
        batches = []
        for bi, bucket in enumerate(self.buckets):
            ids = list(range(len(bucket)))
            if self.shuffle:
                g.shuffle(ids)
            rem = (tb - len(ids) % tb) % tb
            if rem and ids:
                # pad to a whole number of global batches by repeating the
                # list (data_utils.py:352)
                ids = ids + ids * (rem // len(ids)) + ids[:rem % len(ids)]
            ids = ids[self.rank::self.num_replicas]
            for j in range(len(ids) // self.batch_size):
                chunk = ids[j * self.batch_size:(j + 1) * self.batch_size]
                batches.append((bi, [bucket[k] for k in chunk]))
        if self.shuffle:
            batches = [batches[i] for i in g.permutation(len(batches))]
        return batches

    def epoch_batches_global(self, epoch: int
                             ) -> List[Tuple[int, List[int]]]:
        """The global batch sequence: batch j is every rank's j-th batch
        concatenated in rank order, so rows [r * B:(r + 1) * B] are rank
        r's `epoch_batches(epoch)[j]`. Every process computes the same
        list (the shuffles are seeded by the epoch)."""
        per_rank = []
        for r in range(self.num_replicas):
            view = BucketedBatcher.__new__(BucketedBatcher)
            view.__dict__.update(self.__dict__)
            view.rank = r
            per_rank.append(view.epoch_batches(epoch))
        out = []
        for j in range(len(per_rank[0])):
            bi = per_rank[0][j][0]
            assert all(pr[j][0] == bi for pr in per_rank)
            out.append((bi, [i for pr in per_rank for i in pr[j][1]]))
        return out

    def pad_shape(self, bucket_idx: int) -> Tuple[int, int]:
        """(text ids, spectrogram frames) of every batch of the bucket."""
        return self.text_cap, self.boundaries[bucket_idx + 1]

    def make_batch(self, bucket_idx: int,
                   indices: List[int]) -> Dict[str, np.ndarray]:
        """Collate to the bucket's static shape: x [B, T_x] int32, lengths
        [B] int32, and for a multi-speaker dataset sid [B] int32. Device
        spec: int16 wav [B, t_spec * hop + (n_fft - hop), 1] (the sub-hop
        tail and the front end's padding, so the card's spectrogram frames
        see the samples a per-utterance STFT would). Host spec: f32 wav
        [B, t_spec * hop, 1] and spec [B, t_spec, bins] f32."""
        cfg = self.dataset.cfg
        device_spec = self.dataset.device_spec
        t_x, t_spec = self.pad_shape(bucket_idx)
        t_wav = t_spec * cfg.hop_length
        if device_spec:
            t_wav += cfg.filter_length - cfg.hop_length
        b = len(indices)
        n_bins = cfg.filter_length // 2 + 1
        x = np.zeros((b, t_x), np.int32)
        spec = (None if device_spec
                else np.zeros((b, t_spec, n_bins), np.float32))
        wav = np.zeros((b, t_wav, 1), np.int16 if device_spec else np.float32)
        x_lengths, spec_lengths, wav_lengths, sid = (
            np.zeros((b,), np.int32) for _ in range(4))
        for i, idx in enumerate(indices):
            item = self.dataset[idx]
            ids, wv = item["x"], item["wav"]
            lx, lw = min(len(ids), t_x), min(len(wv), t_wav)
            x[i, :lx] = ids[:lx]
            x_lengths[i] = lx
            if device_spec:
                # int16 sources: the round trip through the float is
                # lossless
                wav[i, :lw, 0] = np.clip(np.rint(wv[:lw] * cfg.max_wav_value),
                                         -32768, 32767).astype(np.int16)
                spec_lengths[i] = min(lw // cfg.hop_length, t_spec)
            else:
                sp = item["spec"]
                ls = min(sp.shape[0], t_spec)
                spec[i, :ls] = sp[:ls]
                spec_lengths[i] = ls
                wav[i, :lw, 0] = wv[:lw]
            wav_lengths[i] = lw
            sid[i] = item.get("sid", 0)
        batch = {"x": x, "x_lengths": x_lengths, "spec_lengths": spec_lengths,
                 "wav": wav, "wav_lengths": wav_lengths}
        if spec is not None:
            batch["spec"] = spec
        if self.dataset.multi_speaker:
            batch["sid"] = sid
        return batch

    def iter_epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        for bucket_idx, indices in self.epoch_batches(epoch):
            yield self.make_batch(bucket_idx, indices)
