"""Synthesize one text to a 16-bit wav, with an RTF report (the port's
`run_synthesis.py`).

    python -m mb_istft_vits_torch.synthesize -c configs/ljs_mb_istft_vits.json \
        -t "ðə kwˈɪk bɹˈaʊn fˈɑːks" -o out.wav [-k G.pth] [--device cpu]

Without -k the generator has random weights made from --seed (a smoke
run: the audio is noise). Runs on CUDA unless --device cpu. One warm-up
call runs first, then the timed one. Prints the audio / RTF line, the
first 80 characters of the base64 float32 PCM (all of it with
--print-base64), and last one JSON line: the output path, the device,
the sample count and the timings.
"""

from __future__ import annotations

import argparse
import base64
import json

import numpy as np


def main(argv=None) -> None:
    from mb_istft_vits_torch.infer.synthesis import (
        get_synthesis_module_instance,
    )
    from mb_istft_vits_torch.utils.audio import write_wav

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-t", "--text", required=True,
                    help="text (pre-phonemized IPA for cleaned_text configs)")
    ap.add_argument("-o", "--output", default="out.wav")
    ap.add_argument("-k", "--checkpoint", default=None,
                    help="reference-format G_*.pth")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sid", type=int, default=None)
    ap.add_argument("--noise-scale", type=float, default=0.667)
    ap.add_argument("--length-scale", type=float, default=1.0)
    ap.add_argument("--noise-scale-w", type=float, default=0.8)
    ap.add_argument("--raw-text", action="store_true",
                    help="run the config's cleaners instead of treating the "
                         "input as pre-cleaned phonemes")
    ap.add_argument("--print-base64", action="store_true")
    args = ap.parse_args(argv)

    sm = get_synthesis_module_instance(args.config, args.checkpoint,
                                       seed=args.seed, device=args.device)
    cleaned = not args.raw_text
    sm.synthesize(args.text, sid=args.sid, cleaned=cleaned,
                  seed=args.seed)  # warm-up
    audio, timings = sm.synthesize(
        args.text, sid=args.sid, noise_scale=args.noise_scale,
        length_scale=args.length_scale, noise_scale_w=args.noise_scale_w,
        cleaned=cleaned, seed=args.seed)
    write_wav(args.output, audio, sm.sampling_rate)
    print(f"audio: {timings['audio_seconds']:.3f}s  "
          f"synthesis: {timings['total']:.3f}s  "
          f"Real Time Factor: {timings['rtf']:.4f}")
    b64 = base64.b64encode(audio.astype(np.float32).tobytes()).decode()
    print(f"Base64 encoded data (first 80 chars): {b64[:80]}...")
    if args.print_base64:
        print(b64)
    print(json.dumps({"output": args.output, "device": str(sm.device),
                      "samples": int(audio.size), **timings}))


if __name__ == "__main__":
    main()
