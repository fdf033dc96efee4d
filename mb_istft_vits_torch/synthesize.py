"""Synthesize one text to a 16-bit wav.

    python -m mb_istft_vits_torch.synthesize -c configs/ljs_mb_istft_vits.json \
        -t "ðə kwˈɪk bɹˈaʊn fˈɑːks" -o out.wav [-k G.pth] [--device cuda]

Without -k the generator has random weights made from --seed (a smoke
run: the audio is noise). Runs on CUDA unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import wave


def main(argv=None) -> None:
    from mb_istft_vits_torch.infer.synthesis import SynthesisModule

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-t", "--text", required=True,
                    help="text (pre-phonemized IPA for cleaned_text configs)")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-k", "--checkpoint", default=None,
                    help="reference-format G_*.pth")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise-scale", type=float, default=0.667)
    ap.add_argument("--length-scale", type=float, default=1.0)
    args = ap.parse_args(argv)

    sm = SynthesisModule(args.config, args.checkpoint, seed=args.seed,
                         device=args.device)
    pcm, timings = sm.synthesize(args.text, args.noise_scale,
                                 args.length_scale, seed=args.seed)
    with wave.open(args.output, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sm.sampling_rate)
        w.writeframes(pcm.tobytes())
    print(json.dumps({"output": args.output, "device": str(sm.device),
                      **timings}))


if __name__ == "__main__":
    main()
