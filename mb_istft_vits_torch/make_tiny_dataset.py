"""A tiny on-disk dataset and config for end-to-end CLI drives (the JAX
package's `scripts/make_tiny_dataset.py`, byte for byte): 8 synthetic
wavs at 8 kHz (a tone and noise each, `RandomState(7)`), a filelist of
Japanese phoneme rows and a config of the shrunk multi-band model.

    python -m mb_istft_vits_torch.make_tiny_dataset [OUTDIR]

OUTDIR defaults to `verify_e2e` in the temporary directory. Prints the
config's path; train on it with `python -m mb_istft_vits_torch.train -c
CONFIG -m NAME`.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
from scipy.io.wavfile import write

from mb_istft_vits_torch.utils.audio import float_to_int16


def make(outdir: str = os.path.join(tempfile.gettempdir(), "verify_e2e"),
         fp16_run: bool = True) -> str:
    """Write the wavs, `train.txt` and `cfg.json` into `outdir`; returns
    the config's path."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.RandomState(7)
    texts = ["k o N n i t i w a", "a i u e o k a k i", "t o: ky o: n i i k u",
             "o h a y o: g o z a i m a s u", "s a y o: n a r a",
             "a r i g a t o:", "w a t a s i w a r o b o Q t o",
             "ky o: w a i i t e N k i"]
    rows = []
    for i, n in enumerate([6000, 8000, 9000, 7000, 6500, 8500, 9500, 7500]):
        t = np.arange(n) / 8000.0
        sig = 0.3 * np.sin(2 * np.pi * (150 + 20 * i) * t) \
            + 0.05 * rng.randn(n)
        p = os.path.join(outdir, f"utt{i}.wav")
        write(p, 8000, float_to_int16(sig))
        rows.append(f"{p}|{texts[i]}")
    filelist = os.path.join(outdir, "train.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(rows))
    cfg = {
        "train": {"log_interval": 1, "eval_interval": 100000, "seed": 1234,
                  "epochs": 10000, "learning_rate": 2e-4,
                  "betas": [0.8, 0.99], "eps": 1e-9, "batch_size": 4,
                  "fp16_run": fp16_run, "lr_decay": 0.999875,
                  "segment_size": 512, "c_mel": 45, "c_kl": 1.0,
                  "fft_sizes": [32, 64], "hop_sizes": [8, 16],
                  "win_lengths": [32, 64]},
        "data": {"training_files": filelist, "validation_files": filelist,
                 "text_cleaners": ["japanese_cleaners"],
                 "text_module": "text_JP", "max_wav_value": 32768.0,
                 "sampling_rate": 8000, "filter_length": 256,
                 "hop_length": 64, "win_length": 256, "n_mel_channels": 20,
                 "mel_fmin": 0.0, "mel_fmax": None, "add_blank": True,
                 "n_speakers": 0, "cleaned_text": True},
        "model": {"ms_istft_vits": False, "mb_istft_vits": True,
                  "istft_vits": False, "subbands": 4, "gen_istft_n_fft": 16,
                  "gen_istft_hop_size": 4, "inter_channels": 32,
                  "hidden_channels": 32, "filter_channels": 64,
                  "n_heads": 2, "n_layers": 2, "kernel_size": 3,
                  "p_dropout": 0.1, "resblock": "2",
                  "resblock_kernel_sizes": [3],
                  "resblock_dilation_sizes": [[1, 3]],
                  "upsample_rates": [2, 2], "upsample_initial_channel": 64,
                  "upsample_kernel_sizes": [4, 4], "n_layers_q": 3,
                  "use_spectral_norm": False, "use_sdp": False},
    }
    cfg_path = os.path.join(outdir, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    return cfg_path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    print(make(*argv[:1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
