"""The 2-D (data x model) sharding of the PyTorch port (`parallel/tp.py`)
on the CPU: four gloo ranks (tests/torch_port_dist_worker.py) run one
whole D + G step with both nets sharded over a 2 x 2 mesh, each data
replica on one row of tests/test_torch_port_train.py's ragged batch,
against the port's single-process step on both rows (the worker's
`seeded_state` weights, seeded numpy draws, every dropout off, lr 10 and
eps 10): loss scalars 1e-4 relative, D leaves 1e-4 max-abs, G leaves
outside dp.* 2e-4 relative L2 of their update. The sharding rule is
JAX's `param_spec` in torch's layout, the moments take their weight's
shard's shape (JAX tests/test_train.py:238-259), the full state dict
round-trips through a reference `.pth`, and `create_2d_mesh` refuses what
JAX's refuses, with its words."""

from __future__ import annotations

import concurrent.futures
import shutil

import jax
import numpy as np
import pytest
import torch

from mb_istft_vits_tpu.parallel import create_2d_mesh as jax_create_2d_mesh
from mb_istft_vits_tpu.parallel import param_spec as jax_param_spec

from mb_istft_vits_torch.config import Config, DataConfig, TrainConfig
from mb_istft_vits_torch.models import MultiPeriodDiscriminator, Synthesizer
from mb_istft_vits_torch.nn.layers import Conv1d
from mb_istft_vits_torch.parallel import (
    mesh_shape,
    param_shardings,
    param_spec,
)
from mb_istft_vits_torch.parallel.tp import torch_dims
from mb_istft_vits_torch.train import checkpoint
from mb_istft_vits_torch.train import step as tstep
from mb_istft_vits_torch.weights import load_generator_pth

from tests import torch_port_dist_worker as worker
from tests.test_torch_port_ddp import G_REL, LOSSES, SEED, _g_update_rel
from tests.test_torch_port_train import REL, SEG, ZERO_GRAD_G, _step_batch, \
    rel_err
from tests.torch_port_common import assert_close, configs, n, t


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads in this process, as in the ranks it starts: the
    suite's workers share the cores, and eight threads a worker stall on
    every small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _config():
    train = dict(learning_rate=10.0, eps=10.0, segment_size=SEG,
                 batch_size=1, steps_per_epoch=1)
    return Config(model=configs(p_dropout=0.0)[0], data=DataConfig(),
                  train=TrainConfig(**train))


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """The single-process step and four sharded ranks (2 x 2) from one set of
    weights (the worker's `seeded_state`, which each rank builds itself),
    batch and draws. The files go when the module's tests are done."""
    tmp = tmp_path_factory.mktemp("tp")
    cfg = _config()
    batch = {k: t(v) for k, v in _step_batch().items()}
    rng = np.random.RandomState(22)
    draws = tstep.StepDraws(
        t(rng.randn(2, 40, cfg.model.inter_channels).astype(np.float32)),
        t(np.array([rng.randint(0, 33), rng.randint(0, 25)], np.int32)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(worker.launch, dict(
            world=4, n_model=2, device="cpu", backend="gloo", timeout=240,
            cfg=cfg, seed=SEED, batch=batch, draws=draws, dp_dropout=0.0),
            str(tmp), 300)
        single = worker.seeded_state(cfg, "cpu", SEED, dp_dropout=0.0)
        init_g = {k: v.clone() for k, v in single.net_g.state_dict().items()}
        metrics = {k: float(v) for k, v in
                   tstep.train_step(single, batch, draws).items()}
        ranks = ranks.result()
    yield dict(cfg=cfg, single=single, metrics=metrics, init_g=init_g,
               ranks=ranks, dir=str(tmp))
    shutil.rmtree(tmp, ignore_errors=True)


def test_tp_step_matches_the_single_process_step(tp_run):
    """The pair rank 0 wrote from the full state dicts after the step,
    and every rank's metrics, against the single-process step."""
    single = tp_run["single"]
    for rank in tp_run["ranks"]:
        metrics = rank["compared"][0]["metrics"]
        for k in LOSSES:
            assert rel_err(metrics[k], tp_run["metrics"][k]) <= REL, k
        assert rank["compared"][0]["digest"] \
            == tp_run["ranks"][0]["compared"][0]["digest"]
    d = torch.load(f"{tp_run['dir']}/D_1.pth", weights_only=True)["model"]
    for k, v in single.net_d.state_dict().items():
        assert_close(n(d[k]), n(v), what=k)
    g = load_generator_pth(f"{tp_run['dir']}/G_1.pth")
    compared = 0
    for k, v in single.net_g.state_dict().items():
        if k.startswith("dp."):
            continue
        rel, size = _g_update_rel(g[k], v, tp_run["init_g"][k])
        if k in ZERO_GRAD_G:
            assert size <= 1e-6, k
            continue
        assert size >= 1e-3 and rel <= G_REL, (k, size, rel)
        compared += 1
    assert compared > 200


def test_tp_shards_weights_and_their_moments(tp_run):
    """The weights sharded are those param_shardings names, each rank
    holding half of the named dimension (the same on every data replica),
    at least 10 of them conv weights on dim 0, and each one's AdamW
    moments have its shard's shape."""
    want = {f"{p}.{k}": d for p, net in (("g", Synthesizer(
        tp_run["cfg"].model)), ("d", MultiPeriodDiscriminator()))
        for k, d in param_shardings(net, 2).items() if d is not None}
    for rank in tp_run["ranks"]:
        assert sorted(rank["sharded"]) == sorted(want)
        for k, leaf in rank["sharded"].items():
            shard = list(leaf["whole"])
            shard[want[k]] //= 2
            assert leaf["dim"] == want[k] and leaf["shard"] == shard, k
            assert leaf["moments"] == [shard, shard], k
    conv_dim0 = [k for k, d in want.items()
                 if d == 0 and k.endswith(("weight", "weight_v"))]
    assert len(conv_dim0) >= 10


def test_tp_full_state_dict_round_trips_through_pth(tp_run):
    """G_1.pth / D_1.pth are reference-format pairs: load_generator_pth
    reads G, and a single-process state resumes the pair with its
    optimizers' moments."""
    state = tstep.create_train_state(tp_run["cfg"], torch.device("cpu"),
                                     seed=0)
    assert checkpoint.resume(tp_run["dir"], state) == 1
    g = load_generator_pth(f"{tp_run['dir']}/G_1.pth")
    assert sorted(g) == sorted(state.net_g.state_dict())
    for k, v in state.net_g.state_dict().items():
        assert torch.equal(v, g[k]), k
    single = tp_run["single"]
    for optim, ref in ((state.optim_g, single.optim_g),
                       (state.optim_d, single.optim_d)):
        ours, theirs = optim.state_dict(), ref.state_dict()
        assert sorted(ours["state"]) == sorted(theirs["state"])
        for i, s in theirs["state"].items():
            # the first moment is 0.2 x the gradient: the G leaves' bar
            # on their update (relative L2), where it has a gradient
            ref_m = n(s["exp_avg"]).astype(np.float64)
            size = np.linalg.norm(ref_m)
            err = np.linalg.norm(n(ours["state"][i]["exp_avg"]) - ref_m)
            assert err <= max(G_REL * size, 1e-7), (i, err, size)


@pytest.mark.parametrize("n_model,n_data,n_devices", [
    (3, None, 8), (16, None, 8), (2, 5, 8), (4, 4, 8), (2, None, 8),
    (2, 3, 8)])
def test_create_2d_mesh_refuses_what_jax_refuses(n_model, n_data,
                                                  n_devices):
    """JAX's tiling errors, word for word, and JAX's shape where it
    accepts."""
    try:
        mesh = jax_create_2d_mesh(n_model, n_data, jax.devices()[:n_devices])
        want = (mesh.shape["data"], mesh.shape["model"])
    except ValueError as e:
        want = str(e)
    try:
        got = mesh_shape(n_model, n_data, n_devices)
    except ValueError as e:
        got = str(e)
    assert got == want


@pytest.mark.parametrize("axis", [2, 3, 4])
def test_param_spec_is_jax_rule_in_torch_layout(axis):
    """For every weight of the tiny generator and the discriminator, the
    dimension the port shards is the one JAX's rule picks on the flax
    layout of the same weight (a conv's [out, in, k] is flax's
    [k, in, out])."""
    checked = 0
    for net in (Synthesizer(_config().model), MultiPeriodDiscriminator()):
        for module in net.modules():
            for name, p in module.named_parameters(recurse=False):
                dims = torch_dims(module, p.ndim)
                # flax's layout: trailing first is `dims`
                flax_shape = tuple(p.shape[d] for d in reversed(dims))
                spec = tuple(jax_param_spec(flax_shape, axis))
                want = None
                for i, s in enumerate(spec):
                    if s is not None:
                        want = list(reversed(dims))[i]
                assert param_spec(p.shape, axis, dims=dims) == want, name
                checked += isinstance(module, Conv1d)
    assert checked > 100
