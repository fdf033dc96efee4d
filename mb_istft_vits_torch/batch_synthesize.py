"""Synthesize every line of a filelist in batches, one wav per line (the
port's `run_batch_synthesis.py`).

    python -m mb_istft_vits_torch.batch_synthesize -c configs/ljs_mb_istft_vits.json \
        -f lines.txt -o synth_out [-k G.pth] [--batch 16] [--out-sample-rate 16000] \
        [--device cpu]

A line is `name|text` or `name|sid|text` (sid an integer). Each wav is
named after the stem of `name`; a repeated stem gets `_2`, `_3`, ...
Batch i is seeded with --seed + its first line's index.
--out-sample-rate resamples on the device. Runs on CUDA unless
--device cpu.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Tuple


def read_filelist(path: str) -> List[Tuple[str, Optional[int], str]]:
    """(name, sid, text) for each line with a '|'; others are skipped
    with a message. `name|sid|text` when the middle field is an integer,
    else everything after the first '|' is the text."""
    rows = []
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.rstrip("\n")
            if not line:
                continue
            if "|" not in line:
                print(f"skipping line {ln} (no '|' separator): {line!r}")
                continue
            name, rest = line.split("|", 1)
            sid, text = None, rest
            if "|" in rest:
                maybe_sid, after = rest.split("|", 1)
                if maybe_sid.strip().isdigit():
                    sid, text = int(maybe_sid), after
            rows.append((name, sid, text))
    return rows


def main(argv=None) -> None:
    from mb_istft_vits_torch.infer.synthesis import SynthesisModule
    from mb_istft_vits_torch.utils.audio import write_wav

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-k", "--checkpoint", default=None,
                    help="reference-format G_*.pth (random weights if unset)")
    ap.add_argument("-f", "--filelist", required=True)
    ap.add_argument("-o", "--out-dir", default="synth_out")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--noise-scale", type=float, default=0.667)
    ap.add_argument("--length-scale", type=float, default=1.0)
    ap.add_argument("--noise-scale-w", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-sample-rate", type=int, default=0,
                    help="resample the wavs to this rate on the device "
                         "(0 = the model's rate)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    module = SynthesisModule(args.config, checkpoint_path=args.checkpoint,
                             seed=args.seed, device=args.device)
    rows = read_filelist(args.filelist)
    sr = args.out_sample_rate or module.sampling_rate
    os.makedirs(args.out_dir, exist_ok=True)
    seen_names: dict = {}  # a repeated stem must not overwrite
    total_audio, total_time = 0.0, 0.0
    for lo in range(0, len(rows), args.batch):
        chunk = rows[lo: lo + args.batch]
        audios, timings = module.synthesize_batch(
            [r[2] for r in chunk],
            sids=[r[1] for r in chunk],
            noise_scale=args.noise_scale,
            length_scale=args.length_scale,
            noise_scale_w=args.noise_scale_w,
            seed=args.seed + lo,
            out_sample_rate=args.out_sample_rate or None,
        )
        for (name, _sid, _text), audio in zip(chunk, audios):
            stem = os.path.splitext(os.path.basename(name))[0]
            n = seen_names.get(stem, 0)
            seen_names[stem] = n + 1
            base = f"{stem}.wav" if n == 0 else f"{stem}_{n + 1}.wav"
            write_wav(os.path.join(args.out_dir, base), audio, sr)
        total_audio += timings["audio_seconds"]
        total_time += timings["total"]
        print(f"[{lo + len(chunk)}/{len(rows)}] "
              f"{timings['utterances_per_sec']:.1f} utt/s "
              f"rtf {timings['rtf']:.5f}", flush=True)
    print(f"done: {len(rows)} utterances, {total_audio:.1f}s audio in "
          f"{total_time:.1f}s (overall RTF "
          f"{total_time / max(total_audio, 1e-9):.5f})")


if __name__ == "__main__":
    main()
