"""Generate train/val/test filelists from a corpus directory (a copy of
the JAX package's `scripts/make_filelists.py`, which imports no JAX).

Replaces the reference's shipped static filelists (reference `filelists/`,
24 files: LJSpeech / VCTK / UUDB / CSJ) with a generator, since the lists
are corpus-path-specific. Output format matches the reference exactly:
  single speaker: <wav path>|<text>
  multi speaker:  <wav path>|<sid>|<text>

Usage:
  python -m mb_istft_vits_torch.make_filelists --corpus /data/LJSpeech-1.1 \
      --metadata metadata.csv --ljs-metadata \
      --out filelists/ljs_audio_text --val 100 --test 500
Then phonemize with `python -m mb_istft_vits_torch.preprocess` to
produce the `.cleaned` variants.

--ljs-metadata: LJSpeech's metadata.csv is <id>|<raw>|<normalized>; this
flag keeps only the NORMALIZED column (what the reference filelists use).
It cannot be auto-detected — a 3-column row is also the multi-speaker
<id>|<sid>|<text> format.
"""

import argparse
import os
import random


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--corpus", required=True, help="corpus root directory")
    p.add_argument("--metadata", default="metadata.csv",
                   help="metadata file: <id>|<text> or <id>|<sid>|<text>")
    p.add_argument("--wav-dir", default="wavs")
    p.add_argument("--out", required=True, help="output prefix")
    p.add_argument("--val", type=int, default=100)
    p.add_argument("--test", type=int, default=500)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--ljs-metadata", action="store_true",
                   help="metadata rows are <id>|<raw>|<normalized> "
                        "(LJSpeech metadata.csv): keep only the "
                        "normalized text column")
    args = p.parse_args(argv)

    meta_path = os.path.join(args.corpus, args.metadata)
    rows = []
    with open(meta_path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) < 2:
                continue
            wav = os.path.join(args.corpus, args.wav_dir,
                               parts[0] + ".wav")
            rest = parts[1:]
            if args.ljs_metadata:
                if len(rest) != 2:
                    raise SystemExit(
                        f"--ljs-metadata expects <id>|<raw>|<normalized> "
                        f"rows; got {len(parts)} columns: {line.strip()!r}")
                rest = [rest[1]]  # normalized text only
            rows.append("|".join([wav] + rest))

    random.seed(args.seed)
    random.shuffle(rows)
    n_val, n_test = args.val, args.test
    if n_val + n_test >= len(rows):
        raise SystemExit(
            f"--val {n_val} + --test {n_test} >= {len(rows)} metadata "
            f"rows: the train split would be empty")
    splits = {
        "val": rows[:n_val],
        "test": rows[n_val : n_val + n_test],
        "train": rows[n_val + n_test :],
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for split, lines in splits.items():
        out = f"{args.out}_{split}_filelist.txt"
        with open(out, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        print(f"{out}: {len(lines)} rows")


if __name__ == "__main__":
    main()
