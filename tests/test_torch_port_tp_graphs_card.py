"""The 2-D (data x model) training step through its stage graphs
(`train/graphs.py`: a graph a stage of `train/step.py`, the all-reduces
and the all-gathers of `parallel/tp.py`'s shards run eagerly between
them) on a card, at the tiny width of torch_port_data.py, TF32 off, lr
10 and eps 10 (so the update holds the gradient).

Under cuDNN's and torch's deterministic algorithms a replayed step is
the eager 2-D step from the same weights, draws and dropout seed, bit for
bit, in two gloo ranks sharing the card as a (1 x 2) mesh
(tests/torch_port_dist_worker.py's `replay_vs_eager`). A stage whose
capture fails raises, the step is not taken eagerly instead, and the
CUDA generator is left fit for eager dropout; a weight moved to new
memory inside a capture raises: both on a sharded state of a one-rank
gloo group in this process (a (1 x 1) mesh: every leaf the rule
shards is this rank's whole, and the step is still five stages and four
collectives). Needs a CUDA device and skips without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_tp_graphs_card.py
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_port_dist_worker as worker
from mb_istft_vits_torch.config import Config
from mb_istft_vits_torch.device import disable_tf32
from mb_istft_vits_torch.infer.graphs import WARMUP_ITERS
from mb_istft_vits_torch.parallel import (
    create_2d_mesh,
    dryrun,
    shard_train_state_tp,
)
from mb_istft_vits_torch.train import step as tstep
from torch_port_data import write_tiny_config

CMP_TRAIN = dict(learning_rate=10.0, eps=10.0, batch_size=2)
DETERMINISTIC = {"enabled": True, "deterministic": True}


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    disable_tf32()
    c = Config.from_json(write_tiny_config(str(
        tmp_path_factory.mktemp("tp_graphs_card"))))
    return dataclasses.replace(c, train=dataclasses.replace(
        c.train, **CMP_TRAIN))


@pytest.fixture(scope="module")
def group(cfg):
    """This process as the one rank of a gloo group."""
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://localhost:"
                            f"{dryrun.free_port()}")
    yield
    dist.destroy_process_group()


def _batch(cfg, rows=2, t_spec=40, t_x=11, seed=3):
    d = cfg.data
    rng = np.random.RandomState(seed)
    t_wav = t_spec * d.hop_length + d.filter_length - d.hop_length
    return {"x": torch.from_numpy(rng.randint(1, 40, (rows, t_x)).astype(
                np.int32)),
            "x_lengths": torch.tensor([t_x, t_x - 3][:rows],
                                      dtype=torch.int32),
            "wav": torch.from_numpy(rng.randint(
                -8000, 8000, (rows, t_wav, 1)).astype(np.int16)),
            "spec_lengths": torch.tensor([t_spec, t_spec - 6][:rows],
                                         dtype=torch.int32)}


@pytest.mark.cuda
def test_two_ranks_replays_are_the_eager_2d_step_bit_for_bit(cfg, tmp_path):
    results = worker.launch(dict(
        world=2, n_model=2, device="cuda:0", backend="gloo", timeout=300,
        cfg=cfg, seed=3, batch=_batch(cfg), draws=None, compare=[],
        graph_compare=[DETERMINISTIC]), str(tmp_path), 600)
    for r in results:
        (c,) = r["graph_compare"]
        assert c["replay"]["bit_equal"], c
        assert c["graphs_a_step"] == 5 and c["captures"] == 1
        assert c["replay_route"] == "replay" and c["replay_mas_launches"] == 1
        assert all(leaf["shard"] != leaf["whole"]
                   for leaf in r["sharded"].values())
    assert results[0]["replayed_launches"] == results[1]["replayed_launches"]


@pytest.mark.cuda
def test_a_failed_stage_capture_of_a_2d_state_raises(cfg, group,
                                                      monkeypatch):
    """A stage that reads the device while it is captured: the step raises,
    keeps no graph, takes no eager step and leaves the step count; the
    CUDA generator leaves its capture mode: an eager dropout mask repeats
    under one seed, and an eager step with dropout runs."""
    batch = {k: v.cuda() for k, v in _batch(cfg).items()}
    state = shard_train_state_tp(
        tstep.create_train_state(cfg, torch.device("cuda"), seed=3),
        create_2d_mesh(1))
    assert len(tstep.step_stages(state, batch)) == 5
    for _ in range(WARMUP_ITERS):
        tstep.train_step(state, batch)
    eager, step = state.graphs.eager_steps, state.step
    real = tstep.d_update

    def reads_the_device(st):
        float(st.grad_buffers["d"][0])
        return real(st)

    monkeypatch.setattr(tstep, "d_update", reads_the_device)
    with pytest.raises(RuntimeError):
        tstep.train_step(state, batch)
    torch.cuda.synchronize()
    assert len(state.graphs) == 0 and state.graphs.captures == 0
    assert state.graphs.eager_steps == eager and state.step == step
    monkeypatch.undo()
    masks = []
    for _ in range(2):
        torch.cuda.manual_seed(5)
        masks.append(torch.nn.functional.dropout(
            torch.ones(4096, device="cuda"), 0.5))
    assert torch.equal(*masks) and 0 < int((masks[0] == 0).sum()) < 4096
    metrics = tstep.train_step_eager(tstep.create_train_state(
        cfg, torch.device("cuda"), seed=4), batch)
    assert all(torch.isfinite(v).all() for v in metrics.values())


@pytest.mark.cuda
def test_a_weight_rebound_inside_a_capture_raises(cfg, group, monkeypatch):
    """A stage that moves one of D's whole weights to new memory while it
    is captured (the graphs would read the old address at every replay):
    the capture raises and keeps no graph."""
    batch = {k: v.cuda() for k, v in _batch(cfg).items()}
    state = shard_train_state_tp(
        tstep.create_train_state(cfg, torch.device("cuda"), seed=3),
        create_2d_mesh(1))
    for _ in range(WARMUP_ITERS):
        tstep.train_step(state, batch)
    shards = state.shards["d"]
    real = type(shards).put_whole
    weight = next(state.net_d.parameters())

    def rebinds(self):
        real(self)
        weight.data = weight.data.clone()

    monkeypatch.setattr(type(shards), "put_whole", rebinds)
    with pytest.raises(RuntimeError, match="moved inside the capture"):
        tstep.train_step(state, batch)
    assert len(state.graphs) == 0 and state.graphs.captures == 0
