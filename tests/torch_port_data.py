"""Tiny inputs for the port's JAX-free tests: a config with its model
block shrunk (the serving tests), and tiny training sets for the trainer
CLI: English (seeded int16 wavs, rows of the cleaned LJSpeech test
filelist, the flagship config) or Japanese multi-speaker (`path|sid|text`
rows of the UUDB filelist, `uudb_ms_istft_vits_ms.json`). Imports no JAX,
so the CLI and card tests and chip_smoke.py's `train_cli` phase use it.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
from scipy.io import wavfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "ljs_mb_istft_vits.json")
FILELIST = os.path.join(REPO, "filelists",
                        "ljs_audio_text_test_filelist.txt.cleaned")
MS_CONFIG = os.path.join(REPO, "configs", "uudb_ms_istft_vits_ms.json")
MS_FILELIST = os.path.join(REPO, "filelists",
                           "uudb_audio_sid_text_train_filelist.txt")
TINY_MODEL = dict(inter_channels=16, hidden_channels=16, filter_channels=32,
                  n_layers=1, upsample_initial_channel=32,
                  resblock_kernel_sizes=[3],
                  resblock_dilation_sizes=[[1, 3, 5]])


def drop_checkpoints(root) -> None:
    """Delete every `G_*.pth` / `D_*.pth` under `root`, once a test has
    read what it needs of them: the tiny configs keep the full-size
    discriminator, whose checkpoint with its AdamW moments is 561 MB, and
    pytest keeps the tmp dirs of its last three runs."""
    for path in glob.glob(os.path.join(str(root), "**", "[GD]_*.pth"),
                          recursive=True):
        os.remove(path)


def _tiny(config: str) -> dict:
    """`config` with its model block shrunk to TINY_MODEL (and gin 8 for a
    multi-speaker config)."""
    with open(config) as f:
        cfg = json.load(f)
    cfg["model"].update(TINY_MODEL)
    if cfg["model"].get("gin_channels"):
        cfg["model"]["gin_channels"] = 8
    return cfg


def write_tiny_config(root, config: str = CONFIG) -> str:
    """`config` (the flagship by default) with the model block shrunk, as
    root/tiny.json. Returns its path."""
    path = os.path.join(root, "tiny.json")
    with open(path, "w") as f:
        json.dump(_tiny(config), f)
    return path


def _multi_speaker_rows(n: int):
    """(sid, text) of the shortest MS_FILELIST row of each of speakers
    0 .. n-1."""
    best = {}
    with open(MS_FILELIST, encoding="utf-8") as f:
        for line in f:
            _, sid, text = line.rstrip("\n").split("|")
            if int(sid) < n and len(text) < len(best.get(sid, text + " ")):
                best[sid] = text
    return sorted(best.items(), key=lambda kv: int(kv[0]))


def write_tiny_dataset(root, seed=5, n=6, multi_speaker=False, **train):
    """n seeded int16 wavs (100-150 frames of a tone in noise) and a
    filelist under root, with the config of their language shrunk to
    TINY_MODEL, batch 2, a 2048-sample segment, a metrics line every step
    and the `train` overrides; the filelist is the validation set too.
    English: the n shortest of the first 500 lines of FILELIST, the
    flagship config at 22.05 kHz. multi_speaker: `path|sid|text` rows of
    speakers 0 .. n-1 (MS_FILELIST), MS_CONFIG at 16 kHz. Returns the
    config's path."""
    if multi_speaker:
        config, items = MS_CONFIG, _multi_speaker_rows(n)
    else:
        with open(FILELIST, encoding="utf-8") as f:
            texts = [line.rstrip("\n").split("|")[-1] for line in f][:500]
        config, items = CONFIG, [(None, t) for t in
                                 sorted(texts, key=len)[:n]]
    cfg = _tiny(config)
    sr = cfg["data"]["sampling_rate"]
    rng = np.random.RandomState(seed)
    rows = []
    for i, (sid, text) in enumerate(items):
        samples = int(rng.randint(100, 150)) * 256 + int(rng.randint(256))
        tone = np.sin(2 * np.pi * rng.uniform(90, 250) * np.arange(samples)
                      / sr)
        path = os.path.join(root, f"{i}.wav")
        wavfile.write(path, sr, (3000 * tone + 1000 * rng.randn(samples)
                                 ).astype(np.int16))
        rows.append(f"{path}|{text}" if sid is None
                    else f"{path}|{sid}|{text}")
    with open(os.path.join(root, "train.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")
    cfg["data"]["training_files"] = os.path.join(root, "train.txt")
    cfg["data"]["validation_files"] = cfg["data"]["training_files"]
    cfg["train"].update({"batch_size": 2, "segment_size": 2048,
                         "log_interval": 1, **train})
    path = os.path.join(root, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path
