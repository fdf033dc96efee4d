"""One whole D + G training step of the PyTorch port's multi-stream
multi-speaker model against the JAX package's `make_train_step` on the
CPU: the tiny model of torch_port_common with the MS-iSTFT head, 3
speakers and gin 8, a batch carrying speaker ids, one seeded `.pth`, the
JAX step's draws, and tests/test_torch_port_train.py's method (lr 10,
eps 10). Every dropout is off in both packages, so every generator leaf,
the duration predictor's and the speaker embedding's among them, is
compared."""

from __future__ import annotations

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
from mb_istft_vits_tpu.train.step import TrainState as JTrainState
from mb_istft_vits_tpu.train.step import make_optimizers, make_train_step

from mb_istft_vits_torch.config import Config, DataConfig, TrainConfig
from mb_istft_vits_torch.models import MultiPeriodDiscriminator
from mb_istft_vits_torch.train import step as tstep
from mb_istft_vits_torch.weights import (
    discriminator_state_dict_from_jax,
    state_dict_from_jax,
)

from tests.test_torch_port_train import (
    REL,
    SEG,
    ZERO_GRAD_G,
    _d_from_port,
    _step_batch,
    check_d_step_d_pass,
    check_g_step_d_pass,
    rel_err,
)
from tests.test_torch_port_variants import (
    SID,
    _eps,
    _posterior,
    _variant_configs,
)
from tests.torch_port_common import assert_close, japply, make_weights, n, t


class _NoDropout(flax_nn.Module):
    """Stands in for flax's Dropout while the JAX step is traced: the
    duration predictor's is the only non-zero rate in the generator."""

    rate: float
    deterministic: bool = False

    def __call__(self, x):
        return x


@pytest.fixture(scope="module")
def ms_step(tmp_path_factory):
    """One JAX d_step + g_step and one port train_step from the same
    weights, batch (with speaker ids) and draws, with every dropout off in
    both, lr 10 and eps 10 (tests/test_torch_port_train.py)."""
    tmp = tmp_path_factory.mktemp("ms_step")
    cfg_t, cfg_j = _variant_configs("ms_istft", True, p_dropout=0.0)
    params_g, model = make_weights(tmp, cfg_t, cfg_j)
    torch.manual_seed(12)
    net_d = MultiPeriodDiscriminator()
    params_d = _d_from_port(net_d, tmp)
    train = dict(learning_rate=10.0, eps=10.0, segment_size=SEG,
                 batch_size=2, steps_per_epoch=1)
    jcfg = JConfig(model=cfg_j, data=JDataConfig(),
                   train=JTrainConfig(**train))
    cfg = Config(model=cfg_t, data=DataConfig(), train=TrainConfig(**train))
    batch = dict(_step_batch(), sid=SID)

    synth, jdisc = JSynth(cfg_j), JMPD()
    tx_g, tx_d = make_optimizers(jcfg)
    jp_g = jax.tree.map(jnp.asarray, params_g)
    jp_d = jax.tree.map(jnp.asarray, params_d)
    rng = jax.random.PRNGKey(13)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params_g=jp_g,
                         params_d=jp_d, opt_state_g=tx_g.init(jp_g),
                         opt_state_d=tx_d.init(jp_d), rng=rng)
    jbatch = jax.tree.map(jnp.asarray, batch)
    k_noise, k_drop, k_slice = jax.random.split(
        jax.random.fold_in(rng, 0), 3)
    rngs = {"noise": k_noise, "dropout": k_drop, "slice": k_slice}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn, "Dropout", _NoDropout)
        step_fn = make_train_step(jcfg, synth, jdisc)
        d_out = step_fn.d_step(jstate, jbatch)
        d_ref = {"loss/d/total": float(d_out[2]),
                 "grad_norm_d": float(d_out[3]),
                 "params_d": jax.tree.map(np.array, d_out[0])}
        spec = np.asarray(d_out[4])
        new_state, g_metrics = step_fn.g_step(jstate, jbatch, *d_out)
    ref = {**d_ref, **{k: float(v) for k, v in g_metrics.items()},
           "params_g": jax.tree.map(np.array, new_state.params_g)}
    post = japply(synth, params_g, spec, batch["spec_lengths"], SID,
                  method=_posterior, rngs=rngs, train=True, slice_=True)

    state = tstep.create_train_state(cfg, torch.device("cpu"), seed=0)
    state.net_g.load_state_dict(model.state_dict())
    state.net_d.load_state_dict(discriminator_state_dict_from_jax(params_d))
    state.net_g.dp.drop.p = 0.0
    init_g = {k: v.clone() for k, v in state.net_g.state_dict().items()}
    init_d = {k: v.clone() for k, v in state.net_d.state_dict().items()}
    tbatch = {k: t(v) for k, v in batch.items()}
    draws = tstep.StepDraws(t(_eps(*post[:4])), t(post[4]))
    metrics = tstep.train_step(state, tbatch, draws)
    grads_seen = state.net_g.emb_g.weight.grad.clone()
    return dict(ref=ref, metrics=metrics, state=state, cfg=cfg_t,
                init_g=init_g, init_d=init_d, emb_grad=grads_seen,
                batch=tbatch, draws=draws)


def test_ms_speaker_train_step_matches_make_train_step(ms_step):
    """Loss scalars and grad_norm_d within 1e-4 relative, D leaves within
    1e-4 max-abs; every G leaf's update, less its weight decay, within
    2e-4 relative L2 of the reference's and moved by >= 1e-3 (the
    speaker embedding's rows of speakers not in the batch only decay).
    loss/g/subband is 0 in both: the multi-stream head has no sub-band
    loss."""
    ref, metrics, state = ms_step["ref"], ms_step["metrics"], ms_step["state"]
    assert state.step == 1
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    assert float(metrics["loss/g/subband"]) == ref["loss/g/subband"] == 0.0
    for k in ("loss/d/total", "grad_norm_d", "loss/g/gen", "loss/g/fm",
              "loss/g/mel", "loss/g/kl", "loss/g/dur", "loss/g/total",
              "grad_norm_g", "learning_rate"):
        assert rel_err(metrics[k], ref[k]) <= REL, (k, float(metrics[k]),
                                                    ref[k])
    d_ref = discriminator_state_dict_from_jax(ref["params_d"])
    for k, v in state.net_d.state_dict().items():
        assert_close(n(v), n(d_ref[k]), what=k)
    g_ref = state_dict_from_jax(ref["params_g"], ms_step["cfg"])
    compared = 0
    for k, v in state.net_g.state_dict().items():
        p0 = n(ms_step["init_g"][k]).astype(np.float64)
        d_ours = n(v).astype(np.float64) - 0.9 * p0
        d_ref = n(g_ref[k]).astype(np.float64) - 0.9 * p0
        if k in ZERO_GRAD_G:
            assert max(np.linalg.norm(d_ours), np.linalg.norm(d_ref)) \
                <= 1e-6, k
            continue
        size = np.linalg.norm(d_ref)
        assert size >= 1e-3, (k, size)
        assert np.linalg.norm(d_ours - d_ref) / size <= 2e-4, k
        compared += 1
    assert compared > 200
    assert "emb_g.weight" in g_ref and "dec.multistream_conv_post.weight_v" \
        in g_ref


def test_ms_step_emb_g_gradient_is_the_batch_speakers(ms_step):
    grad = ms_step["emb_grad"]
    moved = sorted(i for i in range(grad.shape[0]) if grad[i].abs().sum() > 0)
    assert moved == sorted(set(SID.tolist()))


@pytest.fixture(scope="module")
def ms_d_pass_state(ms_step):
    """A fresh state of `ms_step`'s config holding its weights from before
    its step (lr 10 leaves weights that no longer make finite scores),
    every dropout off; its batch and draws."""
    state = tstep.create_train_state(ms_step["state"].cfg,
                                     torch.device("cpu"), seed=0)
    state.net_g.load_state_dict(ms_step["init_g"])
    state.net_d.load_state_dict(ms_step["init_d"])
    state.net_g.dp.drop.p = 0.0
    return state, ms_step["batch"], ms_step["draws"]


def test_ms_step_g_step_d_pass_leaves_the_real_half_out_of_autograd(
        ms_d_pass_state):
    """The multi-stream head's G step: D's pass as
    tests/test_torch_port_train.py checks the multi-band head's."""
    check_g_step_d_pass(*ms_d_pass_state)


def test_ms_step_d_step_d_pass_is_one_joint_batch(ms_d_pass_state):
    check_d_step_d_pass(*ms_d_pass_state)
