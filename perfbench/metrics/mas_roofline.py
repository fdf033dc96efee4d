"""The MAS kernels' share of their roofline in the traced window: the
least time of the window's alignment problems over the device time of
the kernels named in `mas_roofline.json`.

A problem's least time is the larger of its bytes over the HBM rate
(each band cell's input read once, the whole [B, T_y, T_x] path written
once, the lengths read) and its operations over the float32 peak (4 a
band cell); the band is each row's max(0, t_x + y - t_y) <= x <
min(t_x, y + 1), y < t_y. It reads the same work whatever implements
it."""

import json
import os
import re

import numpy as np

from perfbench.yardstick.stats import HBM_BYTES_PER_S, PEAK_OPS_PER_S

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "mas_roofline.json")) as _f:
    KERNELS = re.compile(r"\b(" + "|".join(json.load(_f)["kernels"])
                         + r")\b")


def band_cells(t_y: int, t_x: int) -> int:
    y = np.arange(t_y)
    return int(np.maximum(0, np.minimum(t_x, y + 1)
                          - np.maximum(0, t_x + y - t_y)).sum())


def least_seconds(t_y_max: int, t_x_max: int, rows) -> float:
    cells = sum(band_cells(t_y, t_x) for t_y, t_x in rows)
    nbytes = 4 * cells + 4 * len(rows) * t_y_max * t_x_max + 8 * len(rows)
    return max(nbytes / HBM_BYTES_PER_S, 4 * cells / PEAK_OPS_PER_S["float32"])


def read(ctx, result, trace):
    shapes = result["counters"].get("mas_shapes")
    if trace is None or not shapes:
        return None
    busy = sum(min(e, trace.t1) - max(s, trace.t0)
               for s, e, name in trace.in_window(trace.device)
               if KERNELS.search(name)) / 1e9
    if busy <= 0:
        return None
    return 100.0 * sum(least_seconds(*s) for s in shapes) / busy
