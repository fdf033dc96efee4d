"""The measurement tools on a card: each tool's `main()` once in process
at the tiny width of torch_port_data.py (the train segment cut to 2048
samples), one short repetition; its JSON names the card, and every
device field (the tool's `DEVICE_FIELDS`) is finite and > 0;
bench_train's mfu lies in (0, 1.05], bench's length sweep has a device
RTF for each text one program serves, and each route of bench_mas equals the
plain one. Needs a CUDA device and skips without one; imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_bench_card.py
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import math

import pytest
import torch

from mb_istft_vits_torch.utils import timing
from torch_port_data import write_tiny_config

TRAIN_SHAPE = ["--batch", "4", "--spec-frames", "100", "--text-len", "32"]
ARGS = {
    "bench": ["--runs", "3", "--calls", "3"],
    "bench_train": [*TRAIN_SHAPE, "--steps", "2", "--flops", "--feed-host"],
    "bench_batch": ["--batch", "4", "--reps", "2"],
    "bench_stream": ["--reps", "2"],
    "bench_chunk_decode": ["--reps", "2"],
    "bench_microbatch": ["--clients", "4", "--rounds", "2", "--floor"],
    "bench_export": ["--reps", "2"],
    "bench_mas": ["--n", "3", "--reps", "2"],
    "profile_step": [*TRAIN_SHAPE, "--steps", "2"],
    "profile_infer": [],
    "flops_analysis": [*TRAIN_SHAPE, "--infer-frames", "128"],
}


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = write_tiny_config(str(tmp_path_factory.mktemp("bench_card")))
    with open(path) as f:
        cfg = json.load(f)
    cfg["train"]["segment_size"] = 2048
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ARGS))
def test_tool_measures_the_card(name, tiny_config, tmp_path, monkeypatch):
    if name == "bench":  # and its length sweep, the routed text included
        monkeypatch.setenv("MBIV_BENCH_SWEEP", "1")
    argv = list(ARGS[name])
    if name != "bench_mas":
        argv += ["--config", tiny_config]
    if name == "profile_step":
        argv += ["--logdir", str(tmp_path / "prof")]
    module = importlib.import_module(f"mb_istft_vits_torch.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert module.main(argv) == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)
    for path in module.DEVICE_FIELDS:
        values = timing.field_values(out, path)
        assert values and all(isinstance(v, (int, float))
                              and math.isfinite(v) and v > 0
                              for v in values), (path, values)
    if name == "bench":
        sweep = out["rtf_by_length"]
        assert "pieces" in sweep["xlong_routed"]
        assert all(("pieces" in e) != ("rtf_device" in e)
                   for e in sweep.values())
        assert all(math.isfinite(e["rtf_device"]) and e["rtf_device"] > 0
                   for e in sweep.values() if "rtf_device" in e)
    if name == "bench_train":
        assert 0 < out["mfu"] <= 1.05
    if name == "profile_step":
        assert 0 < out["device_busy_share"] <= 1.0
    if name == "bench_mas":
        assert all(r[route]["equals_plain"] for r in out["rows"]
                   for route in ("two_pass", "fused") if "kernel_ms"
                   in r.get(route, {}))
