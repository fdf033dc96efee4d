"""Offline text cleaning of filelists into `.cleaned` files, on the port's
frontends (the JAX package's `preprocess.py`, same arguments and output;
reference preprocess.py:15-25).

    python -m mb_istft_vits_torch.preprocess --filelists F [F ...]
        [--text_index 1] [--text_cleaners english_cleaners2]
        [--text_module text] [--out_extension cleaned]

Each row's column `text_index` is run through the cleaners of
`text_module` ("text" English, "text_JP" Japanese); rows with fewer
columns are dropped with a warning. Writes FILELIST.OUT_EXTENSION beside
each filelist. Host only.
"""

from __future__ import annotations

import argparse
import sys

from mb_istft_vits_torch.data.dataset import load_filepaths_and_text
from mb_istft_vits_torch.text import get_module


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out_extension", default="cleaned")
    ap.add_argument("--text_index", default=1, type=int)
    ap.add_argument("--filelists", nargs="+", required=True)
    ap.add_argument("--text_cleaners", nargs="+",
                    default=["english_cleaners2"])
    ap.add_argument("--text_module", default="text")
    args = ap.parse_args(argv)
    mod = get_module(args.text_module)
    for filelist in args.filelists:
        print("START:", filelist)
        rows = load_filepaths_and_text(filelist,
                                       min_cols=args.text_index + 1)
        for row in rows:
            row[args.text_index] = mod._clean_text(row[args.text_index],
                                                   args.text_cleaners)
        out = filelist + "." + args.out_extension
        with open(out, "w", encoding="utf-8") as f:
            f.writelines(["|".join(r) + "\n" for r in rows])
        print("DONE:", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
