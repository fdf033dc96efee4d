"""Export a serving artifact (torch.export programs per bucket pair, the
weights once, a manifest) from a config and a checkpoint; see
`infer/export.py` (the port's `scripts/export_serving.py`).

    python -m mb_istft_vits_torch.export_serving \
        -c configs/ljs_mb_istft_vits.json -k G_800000.pth -o artifacts/ljs_mb \
        [--platforms cpu cuda] [--pairs 64:256 128:512] [--device cpu]

Without -k the generator has random weights (seed 0). The
programs are traced on CUDA unless --device cpu; an artifact traced on
either device serves on both. Prints the pairs, platforms, directory and
size.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    from mb_istft_vits_torch.infer.export import PLATFORMS, export_serving
    from mb_istft_vits_torch.infer.synthesis import SynthesisModule

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-k", "--checkpoint", default=None,
                    help="reference-format G_*.pth (random init if unset)")
    ap.add_argument("-o", "--out-dir", required=True)
    ap.add_argument("--platforms", nargs="*", default=None,
                    choices=PLATFORMS,
                    help="where the artifact is meant to run "
                         "(default: the tracing device's type)")
    ap.add_argument("--pairs", nargs="*", default=None, metavar="TB:FB",
                    help="explicit text:frame bucket pairs to export")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    pairs = None
    if args.pairs:
        pairs = [tuple(int(v) for v in p.split(":")) for p in args.pairs]

    module = SynthesisModule(args.config, args.checkpoint,
                             device=args.device)
    manifest = export_serving(module, args.out_dir, pairs=pairs,
                              platforms=args.platforms)
    total = sum(
        os.path.getsize(os.path.join(args.out_dir, f))
        for f in os.listdir(args.out_dir)
    )
    print(f"exported {len(manifest['pairs'])} bucket pairs for platforms "
          f"{manifest['platforms']} to {args.out_dir} "
          f"({total / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
