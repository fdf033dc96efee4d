"""Render a training corpus from the repo's filelist text with the
synthetic renderer (`utils.corpus`; the JAX package's
`scripts/make_corpus.py`, same arguments and outputs).

    python -m mb_istft_vits_torch.make_corpus OUTDIR [--dataset ljs|uudb]
        [--n-train 4096] [--n-val 100] [--max-chars 160]

ljs: rows of the cleaned LJSpeech filelists at 22.05 kHz, and the
flagship config pointed at them. uudb: the 12-speaker UUDB phoneme
filelists at 16 kHz, each speaker in its own voice (`_speaker_profile`),
and `uudb_ms_istft_vits_ms.json` pointed at them. Writes OUTDIR/wavs/*.wav
(int16), OUTDIR/train.txt and val.txt, and OUTDIR/config.json; a wav
already there is kept.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from scipy.io.wavfile import write as wav_write

from mb_istft_vits_torch.utils.audio import float_to_int16
from mb_istft_vits_torch.utils.corpus import (
    _plan_jp,
    _speaker_profile,
    render,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(filelist: str, n: int, multi_speaker: bool, max_chars: int):
    """The first n usable rows of a repo filelist: (wav basename, sid or
    None, text)."""
    rows = []
    with open(os.path.join(REPO, "filelists", filelist),
              encoding="utf-8") as f:
        for line in f:
            if multi_speaker:
                p, sid, txt = line.rstrip("\n").split("|", 2)
                # ~0.07 s a token keeps an utterance inside the
                # 1000-frame bucket cap
                if 3 <= len(txt.split()) <= 150:
                    rows.append((os.path.basename(p), int(sid), txt))
            else:
                p, txt = line.rstrip("\n").split("|", 1)
                if 8 <= len(txt) <= max_chars:
                    rows.append((os.path.basename(p), None, txt))
            if len(rows) >= n:
                break
    return rows


def _emit(outdir: str, rows, out_list: str, tag: str, sr: int) -> float:
    """Render the rows missing under OUTDIR/wavs, write the filelist;
    returns the seconds of audio."""
    wav_dir = os.path.join(outdir, "wavs")
    secs, out_rows = 0.0, []
    for base, sid, txt in rows:
        if sid is None:
            wav_path = os.path.join(wav_dir, f"{tag}_{base}")
        else:
            wav_path = os.path.join(wav_dir, f"{tag}_{sid}_{base}")
        if not os.path.exists(wav_path):
            if sid is None:
                audio = render(txt, base, sr=sr)
            else:
                f0, fs = _speaker_profile(sid)
                audio = render(txt, f"{sid}_{base}", base_f0=f0,
                               formant_scale=fs, planner=_plan_jp, sr=sr)
            wav_write(wav_path, sr, float_to_int16(audio))
            secs += len(audio) / sr
        else:
            secs += os.path.getsize(wav_path) / 2 / sr
        out_rows.append(f"{wav_path}|{txt}" if sid is None
                        else f"{wav_path}|{sid}|{txt}")
    with open(os.path.join(outdir, out_list), "w", encoding="utf-8") as f:
        f.write("\n".join(out_rows) + "\n")
    return secs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir")
    ap.add_argument("--dataset", choices=["ljs", "uudb"], default="ljs")
    ap.add_argument("--n-train", type=int, default=4096)
    ap.add_argument("--n-val", type=int, default=100)
    ap.add_argument("--max-chars", type=int, default=160,
                    help="skip longer rows (bucket cap is 1000 spec frames)")
    args = ap.parse_args(argv)
    os.makedirs(os.path.join(args.outdir, "wavs"), exist_ok=True)
    uudb = args.dataset == "uudb"
    if uudb:
        sr, config, lists = 16000, "uudb_ms_istft_vits_ms.json", (
            "uudb_audio_sid_text_train_filelist.txt",
            "uudb_audio_sid_text_test_filelist.txt")
    else:
        sr, config, lists = 22050, "ljs_mb_istft_vits.json", (
            "ljs_audio_text_train_filelist.txt.cleaned",
            "ljs_audio_text_val_filelist.txt.cleaned")
    t_secs = _emit(args.outdir, _rows(lists[0], args.n_train, uudb,
                                      args.max_chars), "train.txt", "tr", sr)
    v_secs = _emit(args.outdir, _rows(lists[1], args.n_val, uudb,
                                      args.max_chars), "val.txt", "va", sr)
    with open(os.path.join(REPO, "configs", config)) as f:
        cfg = json.load(f)
    cfg["data"]["training_files"] = os.path.join(args.outdir, "train.txt")
    cfg["data"]["validation_files"] = os.path.join(args.outdir, "val.txt")
    cfg["train"]["eval_interval"] = 250 if uudb else 500
    cfg["train"]["log_interval"] = 50
    cfg["train"]["fp16_run"] = True
    cfg_path = os.path.join(args.outdir, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    print(f"train {t_secs / 3600:.2f} h, val {v_secs / 3600:.2f} h"
          + (" (12 speakers, 16 kHz)" if uudb else "") + f" -> {cfg_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
