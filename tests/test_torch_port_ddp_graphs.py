"""The data-parallel training step's route through the step graphs
(`train/step.py`'s stages, flat gradient buffers and collectives,
`train/graphs.py`'s keys) and `bench_train` across ranks, on the CPU.

One module-scoped spawn of two gloo ranks (tests/torch_port_dist_worker.py,
which imports the port only; its `route_checks`) at the tiny width of
torch_port_data.py, the train segment cut to 2048 samples, one row a
rank. Each rank checks, bit for bit where the port is held to itself:

- every gradient is a view of its network's flat buffer, and the views
  cover the buffer but its tail, after a step, after its pair is saved
  and resumed, and after a step after that;
- a leaf that never gets a gradient keeps None, and AdamW's weight decay
  does not move it;
- a data-parallel step issues exactly 2 all-reduces, a plain one none;
- a step without draws equals the step given `draw_step`'s rank-local
  draws (metrics and every weight);
- the step graphs' keys record the world size and the backend;
- `bench_train` in that group prints `devices` 2 and the global batch.

And in this process, with torchrun's environment and two cards faked:
`bench_train` starts its rank's group on the card of its local rank.

The data-parallel step's numbers against the single-process step and
JAX's are tests/test_torch_port_ddp.py's.
"""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mb_istft_vits_torch import bench_train
from mb_istft_vits_torch.config import Config

from tests import torch_port_dist_worker as worker
from torch_port_data import write_tiny_config

WORLD = 2
BENCH_BATCH = 4  # the global batch: 2 rows a rank


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' `route_checks`; their files go when the module's tests
    are done."""
    tmp = tmp_path_factory.mktemp("ddp_graphs")
    path = write_tiny_config(str(tmp))
    with open(path) as f:
        cfg_json = json.load(f)
    cfg_json["train"]["segment_size"] = 2048
    with open(path, "w") as f:
        json.dump(cfg_json, f)
    cfg = Config.from_json(path)
    batch = {k: torch.from_numpy(v) for k, v in bench_train.synthetic_batch(
        cfg, WORLD, 40, 16, device_spec=True).items()}
    out = tmp / "ranks"
    out.mkdir()
    spec = dict(world=WORLD, device="cpu", backend="gloo", timeout=240,
                cfg=cfg, seed=0, batch=batch, draws=None, compare=[],
                checks={"bench": [
                    "--config", path, "--batch", str(BENCH_BATCH),
                    "--spec-frames", "40", "--text-len", "16", "--steps",
                    "1", "--flops", "--device", "cpu"]})
    results = worker.launch(spec, str(out), 300)
    yield [r["checks"] for r in results]
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("when", ["after_step", "after_resume",
                                  "after_resume_and_step"])
def test_every_gradient_is_a_view_of_its_flat_buffer(ranks, when):
    for r in ranks:
        views = r[f"views_{when}"]
        for net in ("g", "d"):
            assert views[net]["views"] and views[net]["covered"], (when, net)
            assert views[net]["without_grad"] == [], (when, net)
    assert all(r["resumed"] == 1 for r in ranks)


def test_a_leaf_without_a_gradient_keeps_none(ranks):
    """An extra G leaf that no loss reaches: no gradient after two steps,
    not in the buffer, and its value as made (AdamW skips it, so its
    weight decay does not move it)."""
    for r in ranks:
        leaf = r["unused_leaf"]
        assert leaf["grad_is_none"] and leaf["unchanged"]
        assert leaf["views"]["g"]["without_grad"] == ["unused"]
        assert leaf["views"]["g"]["views"] and leaf["views"]["g"]["covered"]


def test_two_all_reduces_a_data_parallel_step_and_none_a_plain_one(ranks):
    for r in ranks:
        assert r["all_reduces"] == 2
        assert r["plain_all_reduces"] == 0


def test_a_step_without_draws_equals_draw_steps_rank_local_draws(ranks):
    assert all(r["drawn_equals_free"] for r in ranks)


def test_the_keys_record_the_world_and_the_backend(ranks):
    for r in ranks:
        (key,) = r["keys"]
        assert key[6] == torch.device("cpu") and key[7:9] == (WORLD, "gloo")
        (plain,) = r["plain_keys"]
        assert plain[7:9] == (1, None) and plain[-1] == key[-1]


def test_bench_train_over_two_ranks_prints_the_global_batch(ranks):
    """Rank 0 prints the one line: devices 2, the global batch, finite
    losses, the global FLOPs (both ranks' counts, equal shapes: twice
    one rank's), no device field on the CPU; rank 1 prints nothing."""
    line = json.loads(ranks[0]["bench"].strip().splitlines()[-1])
    assert line["devices"] == WORLD and line["batch"] == BENCH_BATCH
    assert line["all_finite"] and line["graphs"] == 1
    assert line["flops_per_step"] > 0
    assert line["flops_per_step"] % WORLD == 0
    for k in bench_train.DEVICE_FIELDS:
        assert line[k] is None, k
    assert np.isfinite(line["step_ms_host"])
    assert ranks[1]["bench"] == ""


def test_bench_train_under_torchrun_runs_on_its_local_ranks_card(
        monkeypatch):
    """Rank 1 of 2 with LOCAL_RANK 1 and two cards (faked: the group's
    start and the card calls record what they are given) sets cuda:1 as
    its device, binds NCCL to it and benches there; no rank of a
    multi-card run lands on card 0."""
    from mb_istft_vits_torch.utils import timing

    for k, v in {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    seen = {}

    def init_process_group(backend, **kwargs):
        seen.update(backend=backend, device_id=kwargs["device_id"])

    def run(args, device):
        seen["bench_device"] = device
        return 0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.setdefault("set_device", d))
    monkeypatch.setattr(timing, "disable_tf32", lambda: None)
    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    monkeypatch.setattr(bench_train, "run", run)
    assert bench_train.main(["--steps", "1"]) == 0
    card = torch.device("cuda", 1)
    assert seen == {"set_device": card, "backend": "nccl",
                    "device_id": card, "bench_device": card}
