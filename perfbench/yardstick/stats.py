"""Statistics of the benchmark: the percentile of request latencies with
unanswered requests counted as missing, the quartile spread, and the
peaks of an NVIDIA H100 (SXM, dense, NVIDIA's data sheet)."""

from __future__ import annotations

import math
import statistics
from typing import Optional, Sequence

# operations a second at each precision, HBM bytes a second
PEAK_OPS_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
                  "float16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def percentile(latencies: Sequence[Optional[float]], q: float) -> float:
    """The nearest-rank q-th percentile of every request due: a request
    that failed or never answered (None) sits above any finite latency,
    so it reads as +inf when the rank lands on it."""
    values = sorted(math.inf if v is None else float(v) for v in latencies)
    if not values:
        return math.inf
    rank = max(1, math.ceil(q / 100.0 * len(values)))
    return values[rank - 1]


def median(values: Sequence[float]) -> float:
    return statistics.median(values)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile over the median
    (`statistics.quantiles(n=4)`, its default method)."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
