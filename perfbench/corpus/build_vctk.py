"""Writes the VCTK serving table, `vctk_test.txt`, from the repo's VCTK
test filelist: one `speaker|cleaned text` line for each of its 500
lines, in the filelist's order. Prints the VCTK training lines' frames
an id: their rendered lengths (the synthetic renderer's length rule,
`mb_istft_vits_torch.utils.corpus.rendered_samples`, at 22.05 kHz, as
`build.py` renders its tables) over hop 256, against their ids with
blanks, which the VITS cell's duration override aims at.

    python perfbench/corpus/build_vctk.py
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from perfbench.yardstick import corpus  # noqa: E402
from mb_istft_vits_torch.utils.corpus import (_plan,  # noqa: E402
                                              rendered_samples)

RATE, HOP = 22050, 256


def _lines(name):
    with open(os.path.join(ROOT, "filelists", name), encoding="utf-8") as f:
        return [line.rstrip("\n").split("|") for line in f]


def main() -> None:
    rows = _lines("vctk_audio_sid_text_test_filelist.txt.cleaned")
    with open(os.path.join(HERE, "vctk_test.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(f"{sid}|{text}" for _, sid, text in rows) + "\n")
    table = corpus.symbols("text")
    frames = ids = 0
    for path, sid, text in _lines(
            "vctk_audio_sid_text_train_filelist.txt.cleaned"):
        base = os.path.basename(path)
        frames += rendered_samples(text, f"{sid}_{base}", _plan,
                                   sr=RATE) // HOP
        ids += len(corpus.text_ids(text, table, False))
    print(f"vctk_test.txt: {len(rows)} lines, "
          f"{len({sid for _, sid, _ in rows})} speakers; VCTK training "
          f"lines: {frames / ids:.4f} frames an id")


if __name__ == "__main__":
    main()
