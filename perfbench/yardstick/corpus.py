"""The benchmark's corpus: the frozen tables of `perfbench/corpus/` (each
line's rendered length in samples, its speaker, its cleaned text), the
cleaned-text-to-ids rule, the trainer's row filters and length buckets,
and the fixed bucket cycle of a training cell.

A row is kept as the trainer's dataset keeps it: text of `min_text_len`
to `max_text_len` characters, ids (blanks interspersed) within the cap
`2 * max_text_len + 1`, and frames (samples // hop) inside the bucket
edges."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(os.path.dirname(HERE), "corpus")

# the trainer's spectrogram-frame bucket edges
BOUNDARIES = (32, 300, 400, 500, 600, 700, 800, 900, 1000)


@dataclass
class Row:
    samples: int
    sid: int
    ids: np.ndarray


def symbols(module: str) -> Dict[str, int]:
    with open(os.path.join(CORPUS, f"symbols_{module}.json"),
              encoding="utf-8") as f:
        return {s: i for i, s in enumerate(json.load(f))}


def text_ids(text: str, table: Dict[str, int], by_token: bool,
             add_blank: bool = True) -> np.ndarray:
    """Cleaned text -> ids: each known symbol (character, or space-separated
    token for the Japanese table), with 0 between them when add_blank."""
    units = text.split(" ") if by_token else text
    ids = [table[u] for u in units if u in table]
    if add_blank:
        out = [0] * (2 * len(ids) + 1)
        out[1::2] = ids
        ids = out
    return np.asarray(ids, np.int64)


def load_rows(table: str, module: str, speakers: bool,
              min_text_len: int, max_text_len: int) -> List[Row]:
    """The table's rows the trainer's dataset keeps (text length and id
    cap; the bucket edges are applied by `bucket_rows`)."""
    sym = symbols(module)
    cap = 2 * max_text_len + 1
    rows = []
    with open(os.path.join(CORPUS, f"{table}.txt"), encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("|")
            samples = int(cols[0])
            sid, text = (int(cols[1]), cols[2]) if speakers else (0, cols[1])
            if not min_text_len <= len(text) <= max_text_len:
                continue
            ids = text_ids(text, sym, module == "text_JP")
            if len(ids) <= cap:
                rows.append(Row(samples, sid, ids))
    return rows


def bucket_of(frames: int, edges: Sequence[int] = BOUNDARIES) -> int:
    for i in range(len(edges) - 1):
        if edges[i] < frames <= edges[i + 1]:
            return i
    return -1


def bucket_rows(rows: Sequence[Row], hop: int,
                edges: Sequence[int] = BOUNDARIES) -> Dict[int, List[int]]:
    """{bucket: indices of its rows}; rows outside the edges are dropped,
    as the trainer drops them."""
    out: Dict[int, List[int]] = {}
    for i, r in enumerate(rows):
        b = bucket_of(r.samples // hop, edges)
        if b >= 0:
            out.setdefault(b, []).append(i)
    return dict(sorted(out.items()))


def steps_per_epoch(buckets: Dict[int, List[int]], batch: int) -> int:
    """Batches an epoch (each bucket padded to whole batches)."""
    return sum(-(-len(v) // batch) for v in buckets.values())


def cycle(buckets: Dict[int, List[int]], steps: int) -> List[int]:
    """A fixed order of about `steps` buckets, each bucket appearing in
    proportion to its share of rows, to the nearest step (a bucket whose
    share rounds to no step is left out), interleaved so that each
    bucket's steps are spread evenly."""
    total = sum(len(v) for v in buckets.values())
    counts = {b: int(round(steps * len(v) / total))
              for b, v in buckets.items()}
    slots = []
    for b, k in counts.items():
        slots += [((j + 0.5) / k, b) for j in range(k)]
    return [b for _, b in sorted(slots)]


def shares(buckets: Dict[int, List[int]], n_rows: int
           ) -> List[Tuple[str, float]]:
    """(edge range, share of all kept rows) of each bucket."""
    out = []
    for b, v in buckets.items():
        out.append((f"({BOUNDARIES[b]},{BOUNDARIES[b + 1]}]",
                    len(v) / n_rows))
    return out


def draw_rows(rng: np.random.Generator, pool: Sequence[int], n: int,
              avoid: Optional[set] = None) -> List[int]:
    """n distinct rows of `pool` (not in `avoid` while it has enough)."""
    cand = [i for i in pool if not avoid or i not in avoid]
    if len(cand) < n:
        cand = list(pool)
    return [int(i) for i in rng.choice(cand, size=n, replace=len(cand) < n)]
