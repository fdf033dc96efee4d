"""Host launches a training step in the traced window: the runtime calls
named in `train_launches_per_step.json` (graph launches, kernel
launches, asynchronous copies), over the window's steps."""

import json
import os

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "train_launches_per_step.json")) as _f:
    CALLS = json.load(_f)["host_calls"]


def read(ctx, result, trace):
    steps = result["counters"].get("steps")
    if trace is None or not steps:
        return None
    n = sum(1 for s, _, name in trace.host
            if trace.t0 <= s < trace.t1 and name.startswith(tuple(CALLS)))
    return n / steps
