"""The data-parallel training step through its stage graphs
(`train/graphs.py`: a graph a stage of `train/step.py`, the all-reduces
run eagerly between them) on a card, at the tiny width of
torch_port_data.py, TF32 off, lr 10 and eps 10 (so the update holds the
gradient).

Under cuDNN's and torch's deterministic algorithms a replayed step is
the eager data-parallel step from the same weights, draws and dropout
seed, bit for bit: in this process as a one-rank gloo group, and in two
gloo ranks sharing the card (tests/torch_port_dist_worker.py's
`replay_vs_eager`). A stage whose capture fails raises, the step is not
taken eagerly instead, and the CUDA generator is left fit for eager
dropout. Needs a CUDA device and skips without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_ddp_graphs_card.py
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
from mb_istft_vits_torch.parallel import dryrun, shard_train_state_dp
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
        tmp_path_factory.mktemp("ddp_graphs_card"))))
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


def _state(cfg):
    return shard_train_state_dp(tstep.create_train_state(
        cfg, torch.device("cuda"), seed=3))


@pytest.mark.cuda
def test_a_one_rank_replay_is_the_eager_step_bit_for_bit(cfg, group):
    batch = {k: v.cuda() for k, v in _batch(cfg).items()}
    with worker.algorithms(DETERMINISTIC):
        gs, es = _state(cfg), _state(cfg)
        init = tuple({k: v.detach().clone() for k, v in
                      net.state_dict().items()}
                     for net in (gs.net_g, gs.net_d))
        for _ in range(WARMUP_ITERS + 1):
            tstep.train_step(gs, batch)
        assert gs.graphs.captures == 1
        assert list(gs.graphs.graphs_a_step.values()) == [3]
        worker.reset_in_place(gs, init)
        gs.step = 0  # es's: the same draws
        replays = gs.graphs.replays
        torch.cuda.manual_seed(11)
        gm = tstep.train_step(gs, batch)
        torch.cuda.manual_seed(11)
        em = tstep.train_step_eager(es, batch)
        torch.cuda.synchronize()
    assert gs.graphs.replays == replays + 1 and gs.graphs.captures == 1
    assert gm.keys() == em.keys()
    assert all(torch.equal(gm[k], em[k]) for k in em)
    gl, el = worker.leaves(gs), worker.leaves(es)
    assert all(torch.equal(gl[k], v) for k, v in el.items())


@pytest.mark.cuda
def test_two_ranks_replays_are_the_eager_step_bit_for_bit(cfg, tmp_path):
    results = worker.launch(dict(
        world=2, device="cuda:0", backend="gloo", timeout=300, cfg=cfg,
        seed=3, batch=_batch(cfg), draws=None, compare=[],
        graph_compare=[DETERMINISTIC]), str(tmp_path), 600)
    for r in results:
        (c,) = r["graph_compare"]
        assert c["replay"]["bit_equal"], c
        assert c["graphs_a_step"] == 3 and c["captures"] == 1
        assert c["replay_route"] == "replay" and c["replay_mas_launches"] == 1
    assert results[0]["replayed_launches"] == results[1]["replayed_launches"]


@pytest.mark.cuda
def test_a_failed_stage_capture_raises(cfg, group, monkeypatch):
    """A stage that reads the device while it is captured: the step raises,
    keeps no graph, takes no eager step and leaves the step count; the
    CUDA generator leaves its capture mode: an eager dropout mask repeats
    under one seed, and an eager step with dropout runs."""
    batch = {k: v.cuda() for k, v in _batch(cfg).items()}
    state = _state(cfg)
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
