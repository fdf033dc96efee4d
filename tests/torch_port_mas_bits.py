"""Arbitrary decision patterns for holding a MAS backtrack against another:
patterns the DP never produces, on lengths at the edges of the 32-column
decision words and the 32-row windows of the CUDA backtrack. numpy only,
so that both the CPU tests (against the JAX package) and the card tests
(which run without JAX) use them."""

from __future__ import annotations

import numpy as np

# name: (T_y, T_x, t_ys, t_xs)
BACKTRACK_CASES = {
    # t_x on both sides of one and two decision words
    "tx_31_32_33_64_65": (100, 65, [100, 90, 80, 70, 100], [31, 32, 33, 64, 65]),
    # t_y below one window, one window, just past it; t_x == 0 and == 1
    "ty_short_tx_0_1": (40, 20, [1, 5, 31, 32, 33, 40], [20, 1, 0, 20, 7, 13]),
    # t_y a multiple of 32 and not, t_y < t_x
    "ty_windows": (130, 100, [128, 96, 130, 40], [100, 100, 50, 100]),
    # the column limit of the kernels
    "tx_8192": (300, 8192, [300, 257], [8192, 4001]),
}

PATTERNS = ("random", "ones", "zeros", "dense", "runs", "even_columns")


def decisions(case: str, pattern: str, seed: int = 0):
    """(dec bool [B, T_y, T_x], t_ys int32 [B], t_xs int32 [B]). Rows
    y >= t_y hold the pattern's complement, so a backtrack that read them
    would move where it should not, or stay where it should move."""
    t_y, t_x, t_ys, t_xs = BACKTRACK_CASES[case]
    b = len(t_ys)
    rng = np.random.RandomState(seed)
    shape = (b, t_y, t_x)
    if pattern == "random":
        dec = rng.rand(*shape) < 0.5
    elif pattern == "ones":  # a move on every row: runs across words
        dec = np.ones(shape, bool)
    elif pattern == "zeros":
        dec = np.zeros(shape, bool)
    elif pattern == "dense":
        dec = rng.rand(*shape) < 0.9
    elif pattern == "runs":  # 40 rows of moves, then 24 of none
        dec = np.broadcast_to((np.arange(t_y) % 64 < 40)[None, :, None],
                              shape).copy()
    elif pattern == "even_columns":  # a move every other row: the cursor
        # crosses each word boundary at both parities
        dec = np.broadcast_to((np.arange(t_x) % 2 == 0)[None, None, :],
                              shape).copy()
    else:
        raise ValueError(pattern)
    t_ys, t_xs = np.asarray(t_ys, np.int32), np.asarray(t_xs, np.int32)
    past = np.arange(t_y)[None, :, None] >= t_ys[:, None, None]
    dec = np.where(past, ~dec, dec)
    return dec, t_ys, t_xs
