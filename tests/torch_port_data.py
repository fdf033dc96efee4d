"""Tiny inputs for the port's JAX-free tests: the flagship config with its
model block shrunk (the serving tests), and a tiny English training set
for the trainer CLI (seeded int16 wavs, rows of the cleaned LJSpeech test
filelist). Imports no JAX, so the CLI and card tests and chip_smoke.py's
`train_cli` phase use it.
"""

from __future__ import annotations

import json
import os

import numpy as np
from scipy.io import wavfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "ljs_mb_istft_vits.json")
FILELIST = os.path.join(REPO, "filelists",
                        "ljs_audio_text_test_filelist.txt.cleaned")
TINY_MODEL = dict(inter_channels=16, hidden_channels=16, filter_channels=32,
                  n_layers=1, upsample_initial_channel=32,
                  resblock_kernel_sizes=[3],
                  resblock_dilation_sizes=[[1, 3, 5]])


def _tiny_flagship() -> dict:
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["model"].update(TINY_MODEL)
    return cfg


def write_tiny_config(root) -> str:
    """The flagship config with the model block shrunk to TINY_MODEL, as
    root/tiny.json. Returns its path."""
    path = os.path.join(root, "tiny.json")
    with open(path, "w") as f:
        json.dump(_tiny_flagship(), f)
    return path


def write_tiny_dataset(root, seed=5, n=6, **train):
    """n seeded int16 wavs (100-150 frames of a tone in noise), a filelist
    of the n shortest of the first 500 lines of FILELIST and the flagship
    config with the model block shrunk to TINY_MODEL, batch 2, a
    2048-sample segment and the `train` overrides, under root. Returns the
    config's path."""
    with open(FILELIST, encoding="utf-8") as f:
        texts = [line.rstrip("\n").split("|")[-1] for line in f][:500]
    rng = np.random.RandomState(seed)
    rows = []
    for i, text in enumerate(sorted(texts, key=len)[:n]):
        samples = int(rng.randint(100, 150)) * 256 + int(rng.randint(256))
        tone = np.sin(2 * np.pi * rng.uniform(90, 250) * np.arange(samples)
                      / 22050)
        path = os.path.join(root, f"{i}.wav")
        wavfile.write(path, 22050, (3000 * tone + 1000 * rng.randn(samples)
                                    ).astype(np.int16))
        rows.append(f"{path}|{text}")
    with open(os.path.join(root, "train.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")
    cfg = _tiny_flagship()
    cfg["data"]["training_files"] = os.path.join(root, "train.txt")
    cfg["train"].update(batch_size=2, segment_size=2048, **train)
    path = os.path.join(root, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path
