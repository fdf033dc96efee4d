"""z round trip: synthesize with z returned, decode the same z again, and
write both wavs (the port's `run_synthesis_z.py`).

    python -m mb_istft_vits_torch.synthesize_z -c configs/ljs_mb_istft_vits.json \
        -t "ðə kwˈɪk bɹˈaʊn fˈɑːks" [-k G.pth] [-o DIR] [--device cpu]

Writes DIR/output_normal.wav and DIR/output_z.wav (DIR defaults to the
working directory), prints the largest sample difference between them,
then one JSON line. Runs on CUDA unless --device cpu.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None) -> None:
    from mb_istft_vits_torch.infer.synthesis import (
        get_synthesis_module_instance,
    )
    from mb_istft_vits_torch.utils.audio import write_wav

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-k", "--checkpoint", default=None)
    ap.add_argument("-t", "--text", required=True)
    ap.add_argument("-o", "--out-dir", default=".")
    ap.add_argument("--sid", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sm = get_synthesis_module_instance(args.config, args.checkpoint,
                                       seed=args.seed, device=args.device)
    audio1, z, _ = sm.synthesize_with_z(args.text, sid=args.sid,
                                        seed=args.seed)
    audio2 = sm.infer_z_only(z, sid=args.sid)
    os.makedirs(args.out_dir, exist_ok=True)
    paths = [os.path.join(args.out_dir, name)
             for name in ("output_normal.wav", "output_z.wav")]
    write_wav(paths[0], audio1, sm.sampling_rate)
    write_wav(paths[1], audio2, sm.sampling_rate)
    n = min(len(audio1), len(audio2))
    err = float(np.abs(audio1[:n] - audio2[:n]).max()) if n else 0.0
    print(f"max |normal - z_decode| = {err:.2e} over {n} samples")
    print(json.dumps({"outputs": paths, "device": str(sm.device),
                      "frames": int(z.shape[0]), "samples": n,
                      "max_abs_diff": err}))


if __name__ == "__main__":
    main()
