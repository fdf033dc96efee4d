"""The controls on the card, at a size a test run holds: the program
passes each cell's limits and the control (the plain reference in TF32,
one precision below the float32 the configurations state) fails at
least one of them. Skips without a CUDA device.

    python -m pytest perfbench -q -m cuda
"""

import pytest
import torch

from perfbench import controls, run
from perfbench.yardstick import compare


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ljs_mb.train_b64", "uudb_ms.train_b32"])
def test_training_control_fails_where_the_program_passes(card, cell):
    ctx = run.context(cell, 2_147_483_701, 0.0, False, card)
    ctx.workload = dict(ctx.workload, batch=8, buckets=[0], cycle_steps=1)
    out = controls.train_readings(ctx, control=True)
    limits = ctx.workload["limits"]
    assert compare.passed(compare.checks(out["program"], limits)), out
    assert not compare.passed(compare.checks(out["control"], limits)), out


@pytest.mark.cuda
def test_serving_control_fails_where_the_program_passes(card):
    ctx = run.context("ljs_mb.serve_open", 2_147_483_702, 3.0, False, card)
    ctx.workload = dict(ctx.workload, rate_per_s=20.0, sample=16)
    out = controls.serve_readings(ctx, control=True)
    limits = ctx.workload["limits"]
    assert compare.passed(compare.checks(out["program"], limits)), out
    assert not compare.passed(compare.checks(out["control"], limits)), out
