"""The 2-D (data x model) training step's route on the CPU
(`parallel/tp.py`'s shards, `train/step.py`'s five stages and four
collectives, `train/graphs.py`'s keys), and the port's 2 x 2 step held
against JAX's own 2-D step.

One module-scoped spawn of four gloo ranks as a 2 x 2 mesh
(tests/torch_port_dist_worker.py, which imports the port only; two torch
threads a rank), each data replica on one row of
tests/test_torch_port_train.py's ragged batch, from the worker's
`seeded_state` weights, every dropout off, lr 10 and eps 10:

- the first step, on JAX's global draws, is held to JAX's
  `create_2d_mesh(2, 2)` + `shard_train_state_tp` + `make_train_step` on 4
  of the 8 host devices tests/conftest.py gives (weights through the
  reference `.pth` bridge, flax's dropout off), and to the port's
  single-process step, at the whole-step bars: loss scalars 1e-4
  relative, D leaves 1e-4 max-abs, G leaves outside dp.* 2e-4 relative L2
  of their update (tests/test_torch_port_train.py's);
- then each rank's `tp_checks`, from the same weights at the config's
  lr and eps: the state is routed; its step is 5 stages and calls 2
  all-reduces and 2 all-gathers; the key records the world, the backend
  and `n_model`; a save (every rank) and a step equal a resume of that
  pair and the same step, bit for bit, and finite;
- the shards and their AdamW moments have the shapes `param_shardings`
  gives, and the ranks end bit-identical.

The 2-D sharding's other tests (the single-process step, the pair's
round trip, the tiling errors and the rule against JAX's) are
tests/test_torch_port_tp.py's.
"""

from __future__ import annotations

import concurrent.futures
import shutil

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mb_istft_vits_tpu.config import Config as JConfig
from mb_istft_vits_tpu.config import DataConfig as JDataConfig
from mb_istft_vits_tpu.config import TrainConfig as JTrainConfig
from mb_istft_vits_tpu.models import MultiPeriodDiscriminator as JMPD
from mb_istft_vits_tpu.models import Synthesizer as JSynth
from mb_istft_vits_tpu.parallel import create_2d_mesh as jax_create_2d_mesh
from mb_istft_vits_tpu.parallel import shard_batch as jax_shard_batch
from mb_istft_vits_tpu.parallel import \
    shard_train_state_tp as jax_shard_train_state_tp
from mb_istft_vits_tpu.train.step import TrainState as JTrainState
from mb_istft_vits_tpu.train.step import make_optimizers, make_train_step

from mb_istft_vits_torch.config import Config, DataConfig, TrainConfig
from mb_istft_vits_torch.models import MultiPeriodDiscriminator, Synthesizer
from mb_istft_vits_torch.parallel import param_shardings
from mb_istft_vits_torch.train import step as tstep
from mb_istft_vits_torch.weights import (
    discriminator_state_dict_from_jax,
    load_generator_pth,
    state_dict_from_jax,
)

from tests import torch_port_dist_worker as worker
from tests.test_torch_port_ddp import G_REL, LOSSES, SEED, _g_update_rel, \
    _jax_generator
from tests.test_torch_port_train import REL, SEG, ZERO_GRAD_G, \
    _d_from_port, _posterior, _step_batch, rel_err
from tests.test_torch_port_variants_train import _NoDropout
from tests.torch_port_common import assert_close, configs, japply, n, t

WORLD, N_MODEL = 4, 2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads in this process, as in the ranks it starts."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tp_graphs(tmp_path_factory):
    """JAX's 2-D step, the port's single-process step and four ranks of
    the port's 2 x 2 step (the compared step, then `tp_checks`), from one
    set of weights, batch and draws; the ranks' files go when the
    module's tests are done."""
    tmp = tmp_path_factory.mktemp("tp_graphs")
    cfg_t, cfg_j = configs(p_dropout=0.0)
    train = dict(learning_rate=10.0, eps=10.0, segment_size=SEG,
                 batch_size=1, steps_per_epoch=1)
    jcfg = JConfig(model=cfg_j, data=JDataConfig(),
                   train=JTrainConfig(**train))
    cfg = Config(model=cfg_t, data=DataConfig(), train=TrainConfig(**train))
    init = worker.seeded_state(cfg, "cpu", SEED, dp_dropout=0.0)
    params_g = _jax_generator(init.net_g, tmp, cfg_j)
    params_d = _d_from_port(init.net_d, tmp)
    batch = _step_batch()

    synth, jdisc = JSynth(cfg_j), JMPD()
    rng = jax.random.PRNGKey(13)
    k_noise, k_drop, k_slice = jax.random.split(
        jax.random.fold_in(rng, 0), 3)
    # JAX's draws of its step (its threefry draws do not depend on the
    # sharding), rebuilt as in tests/test_torch_port_ddp.py
    spec = n(tstep.prep_batch({k: t(v) for k, v in batch.items()},
                              cfg)["spec"])
    z, m_q, logs_q, y_mask, ids = japply(
        synth, params_g, spec, batch["spec_lengths"], method=_posterior,
        rngs={"noise": k_noise, "dropout": k_drop, "slice": k_slice})
    eps = np.where(y_mask > 0, (z - m_q) / np.exp(logs_q), 0.0).astype(
        np.float32)
    draws = tstep.StepDraws(t(eps), t(ids))
    tbatch = {k: t(v) for k, v in batch.items()}

    out = tmp / "ranks"
    out.mkdir()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(worker.launch, dict(
            world=WORLD, n_model=N_MODEL, device="cpu", backend="gloo",
            timeout=240, cfg=cfg, seed=SEED, batch=tbatch, draws=draws,
            dp_dropout=0.0, checks={},
            # the checks' steps: the config's lr and eps (at lr 10 the
            # second step is not finite)
            restart=Config(model=cfg_t, data=DataConfig(),
                           train=TrainConfig(segment_size=SEG,
                                             batch_size=1))),
            str(out), 300)

        mesh = jax_create_2d_mesh(N_MODEL, WORLD // N_MODEL,
                                  devices=jax.devices()[:WORLD])
        tx_g, tx_d = make_optimizers(jcfg)
        jp_g = jax.tree.map(jnp.asarray, params_g)
        jp_d = jax.tree.map(jnp.asarray, params_d)
        jstate = jax_shard_train_state_tp(JTrainState(
            step=jnp.zeros((), jnp.int32), params_g=jp_g, params_d=jp_d,
            opt_state_g=tx_g.init(jp_g), opt_state_d=tx_d.init(jp_d),
            rng=rng), mesh)
        jbatch = jax_shard_batch(jax.tree.map(jnp.asarray, batch), mesh)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax_nn, "Dropout", _NoDropout)
            step_fn = make_train_step(jcfg, synth, jdisc)
            d_out = step_fn.d_step(jstate, jbatch)
            # read before g_step, which donates the state
            jax_ref = {"loss/d/total": float(d_out[2]),
                       "grad_norm_d": float(d_out[3]),
                       "d": discriminator_state_dict_from_jax(jax.tree.map(
                           np.array, d_out[0]))}
            new_state, g_metrics = step_fn.g_step(jstate, jbatch, *d_out)
        jax_ref.update({k: float(v) for k, v in g_metrics.items()})
        jax_ref["g"] = state_dict_from_jax(jax.tree.map(
            np.array, new_state.params_g), cfg_t)
        jax_ref["sharded_g_leaves"] = sum(
            1 for leaf in jax.tree.leaves(new_state.params_g)
            if any(s is not None for s in leaf.sharding.spec))

        init_g = {k: v.clone() for k, v in init.net_g.state_dict().items()}
        single = dict({k: float(v) for k, v in
                       tstep.train_step(init, tbatch, draws).items()},
                      g=init.net_g.state_dict(), d=init.net_d.state_dict())
        ranks = ranks.result()
    yield dict(cfg=cfg, jax=jax_ref, single=single, init_g=init_g,
               ranks=ranks, dir=str(out))
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("against", ["jax_2d", "single_process"])
def test_2d_step_holds_the_reference_step(tp_graphs, against):
    """The pair rank 0 wrote after the first step (whole weights from
    every rank's shards), and every rank's metrics, against JAX's 2-D
    step and the port's single-process step (every dropout off in both,
    so loss/g/dur and grad_norm_g are held too)."""
    ref = tp_graphs["jax" if against == "jax_2d" else "single"]
    for rank in tp_graphs["ranks"]:
        metrics = rank["compared"][0]["metrics"]
        for k in LOSSES:
            assert rel_err(metrics[k], ref[k]) <= REL, (k, metrics[k], ref[k])
    d = torch.load(f"{tp_graphs['dir']}/D_1.pth", weights_only=True)["model"]
    for k, v in ref["d"].items():
        assert_close(n(d[k]), n(v), what=k)
    g = load_generator_pth(f"{tp_graphs['dir']}/G_1.pth")
    compared = 0
    for k, v in ref["g"].items():
        if k.startswith("dp."):
            assert torch.isfinite(g[k]).all(), k
            continue
        rel, size = _g_update_rel(g[k], v, tp_graphs["init_g"][k])
        if k in ZERO_GRAD_G:
            assert size <= 1e-6, k
            continue
        assert size >= 1e-3 and rel <= G_REL, (k, size, rel)
        compared += 1
    assert compared > 200
    if against == "jax_2d":  # JAX really sharded G's weights over "model"
        assert tp_graphs["jax"]["sharded_g_leaves"] >= 10


def test_a_2d_state_is_routed_in_5_stages(tp_graphs):
    for rank in tp_graphs["ranks"]:
        checks = rank["checks"]
        assert checks["routed"] and checks["stages"] == 5


def test_a_2d_step_runs_2_all_reduces_and_2_all_gathers(tp_graphs):
    """Over gloo the all-gathers take c10d's list form, never the
    one-tensor form."""
    for rank in tp_graphs["ranks"]:
        assert rank["checks"]["collectives"] == {"all_reduce": 2,
                                                 "all_gather": 2}


def test_the_key_records_the_world_the_backend_and_n_model(tp_graphs):
    for rank in tp_graphs["ranks"]:
        (key,) = rank["checks"]["keys"]  # the graphs are new after reset
        assert key[6] == torch.device("cpu")
        assert key[7:10] == (WORLD, "gloo", N_MODEL)
        assert rank["checks"]["n_model"] == N_MODEL


def test_shards_and_moments_have_param_shardings_shapes(tp_graphs):
    """Every leaf `param_shardings` names is sharded on its dimension,
    each rank holding 1/N_MODEL of it; its AdamW moments have the shard's
    shape (JAX's `opt_state_shardings`); the rest stay whole."""
    cfg = tp_graphs["cfg"]
    want = {f"{p}.{k}": d for p, net in (("g", Synthesizer(cfg.model)),
                                         ("d", MultiPeriodDiscriminator()))
            for k, d in param_shardings(net, N_MODEL).items()
            if d is not None}
    assert len(want) >= 20
    for rank in tp_graphs["ranks"]:
        assert sorted(rank["sharded"]) == sorted(want)
        for k, leaf in rank["sharded"].items():
            shard = list(leaf["whole"])
            shard[want[k]] //= N_MODEL
            assert leaf["dim"] == want[k] and leaf["shard"] == shard, k
            assert leaf["moments"] == [shard, shard], k


def test_save_resume_and_step_equals_two_steps(tp_graphs):
    for rank in tp_graphs["ranks"]:
        checks = rank["checks"]
        assert checks["resumed"] == checks["saved_at"] == 1
        assert checks["resumed_step_equals_uninterrupted"]
        assert checks["resumed_finite"]


def test_ranks_stay_bit_identical(tp_graphs):
    """Every rank holds the same whole weights after the compared step and
    reports the same finite metrics; no MAS kernel runs on the CPU."""
    first = tp_graphs["ranks"][0]["compared"][0]
    for rank in tp_graphs["ranks"]:
        step = rank["compared"][0]
        assert step["digest"] == first["digest"]
        assert step["metrics"] == first["metrics"]
        assert all(np.isfinite(v) for v in step["metrics"].values())
        assert step["mas_launches"] == 0
