"""Parity of the PyTorch port's stochastic duration predictor (`use_sdp`)
with the JAX package on the CPU: the rational-quadratic spline, DDSConv,
Log, ElementwiseAffine and ConvFlow, the predictor's NLL and reverse,
`Synthesizer.infer` and `forward` of an SDP model, one whole D + G
training step against `make_train_step`, and both `.pth` layouts of the
affine flows' parameters.

Tiny model of torch_port_common with the SDP and 3 speakers (gin 8);
make_weights fills the zero-initialised tensors (ConvFlow.proj, the
affine flows' m and logs) with noise, so no flow is the identity. Draws
are made in JAX and handed to the port: the predictor's noise of a JAX
call is rebuilt from the `noise_rng` it is given, seen through
`flax.linen.intercept_methods` or, inside the jitted train step, from the
step's "noise" stream. Tolerances: 1e-5 on the spline's outputs, 1e-4
max-abs on its log|det| and on modules, relative L2 1e-3 on waveforms,
2e-4 relative L2 on the step's leaf updates; alignments and lengths
exact.
"""

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
from mb_istft_vits_tpu.models.duration import (
    StochasticDurationPredictor as JSDP,
)
from mb_istft_vits_tpu.nn import transforms as jtr
from mb_istft_vits_tpu.nn.blocks import DDSConv as JDDSConv
from mb_istft_vits_tpu.nn.flows import ConvFlow as JConvFlow
from mb_istft_vits_tpu.nn.flows import ElementwiseAffine as JAffine
from mb_istft_vits_tpu.nn.flows import Log as JLog
from mb_istft_vits_tpu.train.checkpoint import export_torch_generator
from mb_istft_vits_tpu.train.step import TrainState as JTrainState
from mb_istft_vits_tpu.train.step import make_optimizers, make_train_step

from mb_istft_vits_torch.config import Config, DataConfig, TrainConfig
from mb_istft_vits_torch.models import MultiPeriodDiscriminator, Synthesizer
from mb_istft_vits_torch.nn import transforms as tr
from mb_istft_vits_torch.train import step as tstep
from mb_istft_vits_torch.weights import (
    discriminator_state_dict_from_jax,
    load_generator_pth,
    state_dict_from_jax,
)

from tests.test_torch_port_train import REL, SEG, ZERO_GRAD_G, _d_from_port
from tests.test_torch_port_train import _step_batch, rel_err
from tests.test_torch_port_variants import (
    HEAD_FLAGS,
    SID,
    SPEAKERS,
    _eps,
    _posterior,
)
from tests.test_torch_port_variants_train import _NoDropout
from tests.torch_port_common import (
    WAV_REL_L2,
    assert_close,
    cl,
    configs,
    japply,
    make_weights,
    n,
    rel_l2,
    t,
)

SPLINE_ATOL = 1e-5
FC = 16  # the predictor's filter channels: hidden_channels of the tiny model


@pytest.fixture(scope="module")
def sdp(tmp_path_factory):
    cfg_t, cfg_j = configs(use_sdp=True, **SPEAKERS)
    params, model = make_weights(tmp_path_factory.mktemp("sdp"), cfg_t, cfg_j)
    return cfg_t, cfg_j, params, model


def _mask(b, t_len, lengths):
    return (np.arange(t_len)[None, :, None]
            < np.asarray(lengths)[:, None, None]).astype(np.float32)


def _sdp_calls(call):
    """call() under an interceptor that records the `noise_rng` of every
    StochasticDurationPredictor call; -> (call's result, [keys])."""
    keys = []

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, JSDP) and \
                context.method_name == "__call__":
            keys.append(kwargs["noise_rng"])
        return next_fun(*args, **kwargs)

    with flax_nn.intercept_methods(record):
        out = call()
    return out, keys


def _normal(key, b, t_x):
    """The predictor's unit noise [B, T_x, 2] under `key`, as it draws it."""
    return np.asarray(jax.random.normal(key, (b, t_x, 2), jnp.float32))


# -- the spline ----------------------------------------------------------------


def _spline_case(seed, inverse, tails):
    """Bin parameters [2, 3, 40, K] and inputs: random ones over both tails
    (or [0, 1] without tails) and, at positions 0..K, the K + 1 knots of
    that position's own spline (x knots forward, y knots inverse)."""
    rng = np.random.RandomState(seed)
    k, shape = 10, (2, 3, 40)
    uw = (0.5 * rng.randn(*shape, k)).astype(np.float32)
    uh = (0.5 * rng.randn(*shape, k)).astype(np.float32)
    ud = rng.randn(*shape, k - 1 if tails else k + 1).astype(np.float32)
    bound = 5.0
    if tails:
        x = rng.uniform(-1.6 * bound, 1.6 * bound, shape)
        lo, hi = -bound, bound
    else:
        x = rng.uniform(0.0, 1.0, shape)
        lo, hi = 0.0, 1.0
    knots, _ = tr._knots(t(uh if inverse else uw), lo, hi, 1e-3)
    for i in range(k + 1):
        x[..., i] = n(knots[..., i, i])
    return x.astype(np.float32), uw, uh, ud


@pytest.mark.parametrize("tails", ["linear", None])
@pytest.mark.parametrize("inverse", [False, True])
def test_spline_matches_jax(inverse, tails):
    """Inside, at every bin edge and (linear tails) beyond +-5, forward and
    inverse: outputs within 1e-5, log|det| within the modules' 1e-4 (a
    difference of logs near the knots, it carries ~5e-5 of f32 round-off:
    the JAX function itself moves by up to 9e-5 between jit and eager on
    these inputs); the tails are the identity with log|det| 0."""
    x, uw, uh, ud = _spline_case(1 + inverse, inverse, tails)
    kw = dict(inverse=inverse, tails=tails)
    if tails:
        kw["tail_bound"] = 5.0
    ref = jax.jit(lambda *a: jtr.piecewise_rational_quadratic_transform(
        *a, **kw))(x, uw, uh, ud)
    ours = tr.piecewise_rational_quadratic_transform(t(x), t(uw), t(uh),
                                                     t(ud), **kw)
    assert_close(n(ours[0]), np.asarray(ref[0]), SPLINE_ATOL, "outputs")
    assert_close(n(ours[1]), np.asarray(ref[1]), what="logabsdet")
    if tails:
        outside = np.abs(x) > 5.0
        assert outside.sum() > 50
        np.testing.assert_array_equal(n(ours[0])[outside], x[outside])
        assert not n(ours[1])[outside].any()


def test_spline_gradient_is_finite_in_the_tails():
    """The spline runs on clamped inputs, so the branch torch.where drops
    stays finite and no NaN comes back through the select."""
    x, uw, uh, ud = _spline_case(3, True, "linear")
    params = [t(a).requires_grad_() for a in (x, uw, uh, ud)]
    out, logdet = tr.piecewise_rational_quadratic_transform(
        *params, inverse=True, tails="linear", tail_bound=5.0)
    (out.sum() + logdet.sum()).backward()
    for p in params:
        assert torch.isfinite(p.grad).all()


# -- the flows' modules ------------------------------------------------------------


def _states(seed, b=2, t_len=23, c=FC):
    rng = np.random.RandomState(seed)
    x = (3.0 * rng.randn(b, t_len, c)).astype(np.float32)
    return x, _mask(b, t_len, [t_len, t_len - 7])


@pytest.mark.parametrize("with_g", [False, True])
def test_dds_conv_matches_flax(sdp, with_g):
    _, _, params, model = sdp
    x, mask = _states(4)
    g = 0.5 * _states(5)[0] if with_g else None
    ref = japply(JDDSConv(FC, 3, 3), params["dp"]["convs"], x, mask, g=g)
    with torch.no_grad():
        ours = model.dp.convs(cl(x), cl(mask), None if g is None else cl(g))
    assert_close(n(ours).transpose(0, 2, 1), ref, what="DDSConv")


@pytest.mark.parametrize("reverse", [False, True])
def test_log_and_affine_flows_match_flax(sdp, reverse):
    _, _, params, model = sdp
    x, mask = _states(6, c=2)
    if not reverse:
        x = np.abs(x) + 0.1
    affine = model.dp.post_flows[0]
    for jmod, p, ours_mod in ((JLog(), {}, model.dp.log_flow),
                              (JAffine(2), params["dp"]["post_flows_0"],
                               affine)):
        ref = japply(jmod, p, x, mask, reverse=reverse)
        with torch.no_grad():
            ours = ours_mod(cl(x), cl(mask), reverse=reverse)
        if reverse:
            assert_close(n(ours).transpose(0, 2, 1), ref)
        else:
            assert_close(n(ours[0]).transpose(0, 2, 1), ref[0])
            assert_close(n(ours[1]), ref[1], what="logdet")
    assert affine.m.shape == (2, 1) and affine.m.abs().sum() > 0


@pytest.mark.parametrize("reverse", [False, True])
def test_conv_flow_matches_flax(sdp, reverse):
    """ConvFlow 1 of the main chain (dp.flows.3), with its non-zero proj:
    the [B, half, T, 3K - 1] regrouping of proj's channels shows here."""
    _, _, params, model = sdp
    x, mask = _states(7, c=2)
    g = _states(8)[0]
    flow = model.dp.flows[3]
    assert flow.proj.weight.abs().sum() > 0
    ref = japply(JConvFlow(2, FC, 3, n_layers=3),
                 params["dp"]["flows_cf_1"], x, mask, g=g, reverse=reverse)
    with torch.no_grad():
        ours = flow(cl(x), cl(mask), cl(g), reverse=reverse)
    if reverse:
        assert_close(n(ours).transpose(0, 2, 1), ref)
    else:
        assert_close(n(ours[0]).transpose(0, 2, 1), ref[0])
        assert_close(n(ours[1]), ref[1], what="logdet")


# -- the predictor -------------------------------------------------------------


def _predictor_inputs(seed, b=2, t_x=13):
    rng = np.random.RandomState(seed)
    h = rng.randn(b, t_x, FC).astype(np.float32)
    mask = _mask(b, t_x, [t_x, t_x - 4])
    w = (rng.randint(1, 7, (b, t_x, 1)) * mask).astype(np.float32)
    g = rng.randn(b, 1, 8).astype(np.float32)
    return h, mask, w, g


def test_sdp_nll_matches_flax(sdp):
    _, _, params, model = sdp
    h, mask, w, g = _predictor_inputs(9)
    key = jax.random.PRNGKey(3)
    jsdp = JSDP(FC, 192, 3, 0.5, 4, gin_channels=8)
    ref = japply(jsdp, params["dp"], h, mask, w=w, g=g, noise_rng=key)
    with torch.no_grad():
        ours = model.dp(cl(h), cl(mask), cl(w), cl(g),
                        noise=cl(_normal(key, 2, 13)))
    assert ours.shape == (2,)
    assert_close(n(ours), ref, what="nll")


@pytest.mark.parametrize("noise_scale", [0.0, 0.8])
def test_sdp_reverse_matches_flax(sdp, noise_scale):
    _, _, params, model = sdp
    h, mask, _, g = _predictor_inputs(10)
    key = jax.random.PRNGKey(4)
    jsdp = JSDP(FC, 192, 3, 0.5, 4, gin_channels=8)
    ref = japply(jsdp, params["dp"], h, mask, g=g, reverse=True,
                 noise_scale=noise_scale, noise_rng=key)
    with torch.no_grad():
        ours = model.dp(cl(h), cl(mask), g=cl(g), reverse=True,
                        noise_scale=noise_scale,
                        noise=cl(_normal(key, 2, 13)))
    assert_close(n(ours).transpose(0, 2, 1), ref, what="logw")


# -- the synthesizer -------------------------------------------------------------


def _text(seed, b=2, t_x=11):
    rng = np.random.RandomState(seed)
    return (rng.randint(1, 40, size=(b, t_x)).astype(np.int32),
            np.array([t_x, t_x - 3], np.int32))


def test_infer_with_sdp_matches_jax(sdp):
    """The JAX draw of the predictor is rebuilt from its noise_rng, the
    prior's from the latents; y_lengths and the alignment are exact, and
    `predict_frames` under the same draw gives the decode's frames."""
    _, cfg_j, params, model = sdp
    x, x_lengths = _text(11)
    max_frames = 80

    def fn(p, x, xl, sid):
        return _sdp_calls(lambda: JSynth(cfg_j).apply(
            {"params": p}, x, xl, sid, 1.0, 1.0, 0.8, max_frames,
            method=JSynth.infer, rngs={"noise": jax.random.PRNGKey(12)}))

    ref, keys = jax.jit(fn)(params, x, x_lengths, SID)
    ref = jax.tree.map(np.asarray, ref)
    w_eps = _normal(keys[0], 2, 11)
    _, r_zp, r_mp, r_logsp = ref.latents
    eps = ((r_zp - r_mp) / np.exp(r_logsp)).astype(np.float32)
    with torch.no_grad():
        out = model.infer(t(x).long(), t(x_lengths), t(SID).long(), 1.0, 1.0,
                          0.8, max_frames, eps=t(eps), w_eps=t(w_eps))
        frames = model.predict_frames(t(x).long(), t(x_lengths),
                                      t(SID).long(), 1.0, 0.8,
                                      w_eps=t(w_eps))
    np.testing.assert_array_equal(n(out.y_lengths), ref.y_lengths)
    np.testing.assert_array_equal(n(frames), ref.y_lengths)
    np.testing.assert_array_equal(n(out.attn), ref.attn)
    for ours, r, what in zip(out.latents, ref.latents,
                             "z z_p m_p logs_p".split()):
        assert_close(n(ours), r, what=what)
    assert rel_l2(n(out.o), ref.o) <= WAV_REL_L2


def test_forward_l_length_with_sdp_matches_jax(sdp):
    _, cfg_j, params, model = sdp
    x, x_lengths = _text(13)
    rng = np.random.RandomState(14)
    y = (rng.randn(2, 40, 513) ** 2).astype(np.float32)
    y_lengths = np.array([40, 32], np.int32)

    def fn(p, *a):
        return _sdp_calls(lambda: JSynth(cfg_j).apply(
            {"params": p}, *a, train=False,
            rngs={"noise": jax.random.PRNGKey(15),
                  "slice": jax.random.PRNGKey(16)}))

    ref, keys = jax.jit(fn)(params, x, x_lengths, y, y_lengths, SID)
    ref = jax.tree.map(np.asarray, ref)
    (_, _, r_l, r_attn, r_ids, _, r_ymask,
     (r_z, _, _, _, r_mq, r_logsq)) = ref
    with torch.no_grad():
        out = model(t(x).long(), t(x_lengths), t(y), t(y_lengths),
                    t(SID).long(), posterior_eps=t(_eps(r_z, r_mq, r_logsq,
                                                        r_ymask)),
                    ids_slice=t(r_ids), sdp_eps=t(_normal(keys[0], 2, 11)))
    np.testing.assert_array_equal(n(out[3]), r_attn)
    assert out[2].dtype == torch.float32
    assert_close(n(out[2]), r_l, what="l_length")


# -- weights ---------------------------------------------------------------------


def test_both_pth_layouts_of_the_affine_flows_load(sdp, tmp_path):
    """The reference's [2, 1] (make_weights writes the port's own state
    dict) and the JAX exporter's (2,) both load into the port."""
    cfg_t, cfg_j, params, model = sdp
    ours = state_dict_from_jax(params, cfg_t)
    assert ours["dp.flows.0.m"].shape == ours["dp.post_flows.0.logs"].shape \
        == (2, 1)
    path = str(tmp_path / "G_export.pth")
    export_torch_generator(params, cfg_j, path)
    assert torch.load(path, weights_only=True)["model"][
        "dp.flows.0.m"].shape == (2,)
    reference = str(tmp_path / "G_ref.pth")
    torch.save({"model": model.state_dict(), "iteration": 0,
                "learning_rate": 2e-4, "optimizer": None}, reference)
    for sd in (load_generator_pth(path), load_generator_pth(reference)):
        assert sorted(sd) == sorted(ours)
        for k, v in ours.items():
            assert torch.equal(v, sd[k].float()), k
        Synthesizer(cfg_t).load_state_dict(sd)  # strict


# -- one training step -------------------------------------------------------------


def _draws(m, spec, spec_lengths, sid):
    """The JAX step's draws, as `Synthesizer.__call__` takes them: the
    posterior's "noise" and the slice's "slice" (_posterior), then the
    predictor's key, the second "noise"."""
    z, m_q, logs_q, y_mask, ids = _posterior(m, spec, spec_lengths, sid,
                                             train=True, slice_=True)
    key = m.make_rng("noise")
    return z, m_q, logs_q, y_mask, ids, key


@pytest.fixture(scope="module")
def sdp_step(tmp_path_factory):
    """One JAX d_step + g_step and one port train_step of the SDP model
    (multi-stream head, 3 speakers: no sub-band loss, so every G leaf is
    held at one tolerance) from the same weights, batch and draws, every
    dropout off in both, lr 10 and eps 10 (tests/test_torch_port_train.py)."""
    tmp = tmp_path_factory.mktemp("sdp_step")
    cfg_t, cfg_j = configs(use_sdp=True, p_dropout=0.0, **SPEAKERS,
                           **HEAD_FLAGS["ms_istft"])
    params_g, model = make_weights(tmp, cfg_t, cfg_j)
    torch.manual_seed(12)
    params_d = _d_from_port(MultiPeriodDiscriminator(), tmp)
    train = dict(learning_rate=10.0, eps=10.0, segment_size=SEG,
                 batch_size=2, steps_per_epoch=1)
    jcfg = JConfig(model=cfg_j, data=JDataConfig(),
                   train=JTrainConfig(**train))
    cfg = Config(model=cfg_t, data=DataConfig(), train=TrainConfig(**train))
    batch = dict(_step_batch(), sid=SID)

    synth = JSynth(cfg_j)
    tx_g, tx_d = make_optimizers(jcfg)
    jp_g = jax.tree.map(jnp.asarray, params_g)
    jp_d = jax.tree.map(jnp.asarray, params_d)
    rng = jax.random.PRNGKey(13)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params_g=jp_g,
                         params_d=jp_d, opt_state_g=tx_g.init(jp_g),
                         opt_state_d=tx_d.init(jp_d), rng=rng)
    k_noise, k_drop, k_slice = jax.random.split(
        jax.random.fold_in(rng, 0), 3)
    rngs = {"noise": k_noise, "dropout": k_drop, "slice": k_slice}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax_nn, "Dropout", _NoDropout)
        step_fn = make_train_step(jcfg, synth, JMPD())
        d_out = step_fn.d_step(jstate, jax.tree.map(jnp.asarray, batch))
        # read before g_step, which donates D's outputs
        d_ref = {"loss/d/total": float(d_out[2]),
                 "grad_norm_d": float(d_out[3]),
                 "params_d": jax.tree.map(np.array, d_out[0])}
        spec = np.asarray(d_out[4])
        new_state, g_metrics = step_fn.g_step(
            jstate, jax.tree.map(jnp.asarray, batch), *d_out)
    ref = {**d_ref, **{k: float(v) for k, v in g_metrics.items()},
           "params_g": jax.tree.map(np.array, new_state.params_g)}
    *post, key = japply(synth, params_g, spec, batch["spec_lengths"], SID,
                        method=_draws, rngs=rngs)

    state = tstep.create_train_state(cfg, torch.device("cpu"), seed=0)
    state.net_g.load_state_dict(model.state_dict())
    state.net_d.load_state_dict(discriminator_state_dict_from_jax(params_d))
    for dds in (state.net_g.dp.convs, state.net_g.dp.post_convs):
        dds.drop.p = 0.0
    init_g = {k: v.clone() for k, v in state.net_g.state_dict().items()}
    t_x = batch["x"].shape[1]
    metrics = tstep.train_step(state, {k: t(v) for k, v in batch.items()},
                               tstep.StepDraws(t(_eps(*post[:4])), t(post[4]),
                                               t(_normal(key, 2, t_x))))
    return dict(ref=ref, metrics=metrics, state=state, cfg=cfg_t,
                init_g=init_g)


def test_sdp_train_step_matches_make_train_step(sdp_step):
    """Loss scalars (loss/g/dur the flow NLL) and grad_norm_d within 1e-4
    relative, D leaves 1e-4 max-abs; every G leaf's update, the dp.*
    leaves included, less its weight decay, within 2e-4 relative L2 of
    the reference's and moved by >= 1e-3."""
    ref, metrics, state = sdp_step["ref"], sdp_step["metrics"], \
        sdp_step["state"]
    assert state.step == 1
    for k in ("loss/d/total", "grad_norm_d", "loss/g/gen", "loss/g/fm",
              "loss/g/mel", "loss/g/kl", "loss/g/dur", "loss/g/total",
              "grad_norm_g", "learning_rate"):
        assert rel_err(metrics[k], ref[k]) <= REL, (k, float(metrics[k]),
                                                    ref[k])
    d_ref = discriminator_state_dict_from_jax(ref["params_d"])
    for k, v in state.net_d.state_dict().items():
        assert_close(n(v), n(d_ref[k]), what=k)
    g_ref = state_dict_from_jax(ref["params_g"], sdp_step["cfg"])
    compared = dp = 0
    for k, v in state.net_g.state_dict().items():
        p0 = n(sdp_step["init_g"][k]).astype(np.float64)
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
        dp += k.startswith("dp.")
    assert dp > 100 and compared > 300
