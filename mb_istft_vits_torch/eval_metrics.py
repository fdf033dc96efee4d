"""Objective scores of wav pairs (the JAX package's
`scripts/eval_metrics.py`, same arguments, lines and JSON).

    python -m mb_istft_vits_torch.eval_metrics REF TEST [--json OUT]

REF and TEST are two wavs, or two directories whose same-named wavs are
paired. Each pair gets the suite of `utils.metrics`: MCD, log-spectral
distance, and (for pairs of at least 4096 samples) F0 RMSE in Hz and
cents, gross pitch error and voicing decision error. The pair must be
time-aligned: ground truth against copy synthesis, or two decodes of the
same latents. Host only (numpy, and the port's STFT on the CPU), as in
the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

KEYS = ("mcd_db", "lsd_db", "f0_rmse_hz", "f0_rmse_cents",
        "gross_pitch_error", "voicing_decision_error")


def _load(path: str):
    from mb_istft_vits_torch.data.dataset import load_wav

    audio, sr = load_wav(path)
    audio = np.asarray(audio, np.float32)
    if np.abs(audio).max() > 2.0:  # an integer wav: the loader's scale
        audio = audio / 32768.0
    return audio, sr


def pair_metrics(ref_path: str, test_path: str) -> dict:
    """The scores of one pair, with its paths and rate."""
    from mb_istft_vits_torch.utils.metrics import (
        f0_metrics,
        log_spectral_distance,
        mel_cepstral_distortion,
    )

    ref, sr_a = _load(ref_path)
    test, sr_b = _load(test_path)
    if sr_a != sr_b:
        raise SystemExit(
            f"sample-rate mismatch: {ref_path} {sr_a} vs {test_path} {sr_b}"
            " (resample first, e.g. dsp.resample.resample_poly)")
    out = {"ref": ref_path, "test": test_path, "sr": sr_a,
           "mcd_db": mel_cepstral_distortion(ref, test, sr_a),
           "lsd_db": log_spectral_distance(ref, test, sr_a)}
    if min(len(ref), len(test)) >= 4096:
        out.update(f0_metrics(ref, test, sr_a))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ref", help="reference wav file or directory")
    ap.add_argument("test", help="test wav file or directory")
    ap.add_argument("--json", default=None,
                    help="write per-pair results to this JSON file")
    args = ap.parse_args(argv)
    if os.path.isdir(args.ref):
        names = sorted(n for n in os.listdir(args.ref) if n.endswith(".wav")
                       and os.path.exists(os.path.join(args.test, n)))
        if not names:
            raise SystemExit("no same-named wav pairs found")
        pairs = [(os.path.join(args.ref, n), os.path.join(args.test, n))
                 for n in names]
    else:
        pairs = [(args.ref, args.test)]
    results = [pair_metrics(r, t) for r, t in pairs]
    for res in results:
        line = "  ".join(f"{k}={res[k]:.4f}" for k in KEYS if k in res)
        print(f"{os.path.basename(res['test'])}: {line}")
    if len(results) > 1:
        print("mean: " + "  ".join(
            f"{k}={np.mean([r[k] for r in results if k in r]):.4f}"
            for k in KEYS if any(k in r for r in results)))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
