"""Writes the benchmark's frozen corpus tables from the repo's filelists:
each line's rendered length in samples (the synthetic renderer's length
rule, `mb_istft_vits_torch.utils.corpus.rendered_samples`, at the
config's rate), its speaker and its cleaned text, and the symbol tables
that map cleaned text to ids. The benchmark reads only the tables, so a
later change to the filelists or the renderer leaves its traffic alone.

    python perfbench/corpus/build.py
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from mb_istft_vits_torch.text import get_symbols  # noqa: E402
from mb_istft_vits_torch.utils.corpus import (_plan, _plan_jp,  # noqa: E402
                                              rendered_samples)

TABLES = (
    # (table, filelist, speakers, rate)
    ("ljs_train", "ljs_audio_text_train_filelist.txt.cleaned", False, 22050),
    ("uudb_train", "uudb_audio_sid_text_train_filelist.txt", True, 16000),
)


def main() -> None:
    for table, filelist, speakers, sr in TABLES:
        out = []
        with open(os.path.join(ROOT, "filelists", filelist),
                  encoding="utf-8") as f:
            for line in f:
                cols = line.rstrip("\n").split("|")
                base = os.path.basename(cols[0])
                if speakers:
                    sid, text = int(cols[1]), cols[2]
                    n = rendered_samples(text, f"{sid}_{base}", _plan_jp,
                                         sr=sr)
                    out.append(f"{n}|{sid}|{text}")
                else:
                    n = rendered_samples(cols[1], base, _plan, sr=sr)
                    out.append(f"{n}|{cols[1]}")
        with open(os.path.join(HERE, f"{table}.txt"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(out) + "\n")
    with open(os.path.join(ROOT, "filelists",
                           "ljs_audio_text_test_filelist.txt.cleaned"),
              encoding="utf-8") as f:
        texts = [line.rstrip("\n").split("|")[1] for line in f]
    with open(os.path.join(HERE, "ljs_test.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(texts) + "\n")
    for module in ("text", "text_JP"):
        with open(os.path.join(HERE, f"symbols_{module}.json"), "w",
                  encoding="utf-8") as f:
            json.dump(get_symbols(module), f, ensure_ascii=False)


if __name__ == "__main__":
    main()
