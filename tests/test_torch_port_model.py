"""Model-level parity of the PyTorch port with the JAX package on the CPU:
decoder, encoders, duration predictor, prior flow, `Synthesizer.infer`,
`forward` and `decode`, and the weight bridge. Tolerances: f32 max-abs
<= 1e-4 per module (torch_port_common.ATOL), waveform relative L2 <= 1e-3;
alignments, lengths and slice starts are exact."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from mb_istft_vits_tpu.models import Synthesizer as JaxSynthesizer
from mb_istft_vits_tpu.models.decoders import MultibandISTFTGenerator as JDec
from mb_istft_vits_tpu.models.duration import DurationPredictor as JDp
from mb_istft_vits_tpu.models.encoders import PosteriorEncoder as JEncQ
from mb_istft_vits_tpu.models.encoders import TextEncoder as JEncP
from mb_istft_vits_tpu.models.synthesizer import ResidualCouplingBlock as JFlow
from mb_istft_vits_tpu.train.checkpoint import export_torch_generator

from mb_istft_vits_torch.weights import load_generator_pth, state_dict_from_jax

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


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    cfg_t, cfg_j = configs()
    params, model = make_weights(tmp_path_factory.mktemp("w"), cfg_t, cfg_j)
    return cfg_t, cfg_j, params, model


def _batch(seed=0, b=2, t_x=11, t_y=40, spec=513):
    rng = np.random.RandomState(seed)
    x = rng.randint(1, 40, size=(b, t_x)).astype(np.int32)
    x_lengths = np.array([t_x, t_x - 3], np.int32)
    y = (rng.randn(b, t_y, spec) ** 2).astype(np.float32)
    y_lengths = np.array([t_y, t_y - 8], np.int32)
    return x, x_lengths, y, y_lengths


def _ids(x):
    return t(x.astype(np.int64))


# -- 11: decoder -------------------------------------------------------------


def test_decoder_matches_flax(weights):
    cfg, cfg_j, params, model = weights
    z = np.random.RandomState(1).randn(2, 13, cfg.inter_channels).astype(
        np.float32)
    o, o_mb, spec, phase = model.dec(cl(z))
    jdec = JDec(cfg_j.inter_channels, cfg_j.resblock,
                cfg_j.resblock_kernel_sizes, cfg_j.resblock_dilation_sizes,
                cfg_j.upsample_rates, cfg_j.upsample_initial_channel,
                cfg_j.upsample_kernel_sizes, cfg_j.gen_istft_n_fft,
                cfg_j.gen_istft_hop_size, cfg_j.subbands)
    r_o, r_mb, r_spec, r_phase = japply(jdec, params["dec"], z)
    assert_close(n(spec).transpose(0, 3, 1, 2), r_spec, what="spec")
    assert_close(n(phase).transpose(0, 3, 1, 2), r_phase, what="phase")
    assert rel_l2(n(o_mb), r_mb) <= WAV_REL_L2
    assert rel_l2(n(o).transpose(0, 2, 1), r_o) <= WAV_REL_L2
    assert o.shape == (2, 1, 13 * 256)


# -- 12, 13, 14: encoders, duration predictor, flow -----------------------------


def test_text_encoder_and_duration_predictor_match_flax(weights):
    cfg, cfg_j, params, model = weights
    x, x_lengths, _, _ = _batch(2)
    h, m, logs, x_mask = model.enc_p(_ids(x), t(x_lengths))
    jenc = JEncP(cfg.n_vocab, cfg.inter_channels, cfg.hidden_channels,
                 cfg.filter_channels, cfg.n_heads, cfg.n_layers,
                 cfg.kernel_size, cfg.p_dropout)
    r_h, r_m, r_logs, r_mask = japply(jenc, params["enc_p"], x, x_lengths)
    for ours, ref, what in ((h, r_h, "h"), (m, r_m, "m"),
                            (logs, r_logs, "logs"), (x_mask, r_mask, "mask")):
        assert_close(n(ours).transpose(0, 2, 1), ref, what=what)
    logw = model.dp(h, x_mask)
    r_logw = japply(JDp(cfg.hidden_channels, 256, 3, 0.5), params["dp"],
                    r_h, r_mask)
    assert_close(n(logw).transpose(0, 2, 1), r_logw, what="logw")


def test_posterior_encoder_matches_flax(weights):
    cfg, cfg_j, params, model = weights
    _, _, y, y_lengths = _batch(3)
    jenc = JEncQ(cfg.spec_channels, cfg.inter_channels, cfg.hidden_channels,
                 5, 1, 16)
    r_z, r_m, r_logs, r_mask = japply(jenc, params["enc_q"], y, y_lengths,
                                      noise_rng=jax.random.PRNGKey(4))
    # the JAX draw, recovered inside the mask (zero outside)
    eps = np.where(r_mask > 0, (r_z - r_m) / np.exp(r_logs), 0.0).astype(
        np.float32)
    z, m, logs, y_mask = model.enc_q(cl(y), t(y_lengths), eps=cl(eps))
    for ours, ref, what in ((z, r_z, "z"), (m, r_m, "m"),
                            (logs, r_logs, "logs"), (y_mask, r_mask, "mask")):
        assert_close(n(ours).transpose(0, 2, 1), ref, what=what)


@pytest.mark.parametrize("reverse", [False, True])
def test_coupling_block_matches_flax(weights, reverse):
    cfg, cfg_j, params, model = weights
    rng = np.random.RandomState(5)
    x = rng.randn(2, 19, cfg.inter_channels).astype(np.float32)
    mask = (np.arange(19)[None, :, None] < np.array([19, 12])[:, None, None]
            ).astype(np.float32)
    ours = model.flow(cl(x), cl(mask), reverse=reverse)
    ref = japply(JFlow(cfg.inter_channels, cfg.hidden_channels, 5, 1, 4),
                 params["flow"], x, mask, reverse=reverse)
    assert_close(n(ours).transpose(0, 2, 1), ref)


# -- 14: Synthesizer -------------------------------------------------------------


def test_infer_matches_jax(weights):
    cfg, cfg_j, params, model = weights
    x, x_lengths, _, _ = _batch(6)
    max_frames = 60
    ref = japply(JaxSynthesizer(cfg_j), params, x, x_lengths,
                 method=JaxSynthesizer.infer, rngs={"noise": jax.random
                                                    .PRNGKey(7)},
                 max_frames=max_frames)
    _, r_zp, r_mp, r_logsp = ref.latents
    eps = ((r_zp - r_mp) / np.exp(r_logsp)).astype(np.float32)
    with torch.no_grad():
        out = model.infer(_ids(x), t(x_lengths), max_frames=max_frames,
                          eps=t(eps))
    np.testing.assert_array_equal(n(out.y_lengths), ref.y_lengths)
    np.testing.assert_array_equal(n(out.attn), ref.attn)
    np.testing.assert_array_equal(n(out.y_mask), ref.y_mask)
    for ours, r, what in zip(out.latents, ref.latents, "z z_p m_p logs_p"
                             .split()):
        assert_close(n(ours), r, what=what)
    assert_close(n(out.spec), ref.spec, what="spec")
    assert out.o.shape == ref.o.shape == (2, max_frames * 256, 1)
    assert rel_l2(n(out.o), ref.o) <= WAV_REL_L2
    # the duration probe agrees with the decode
    with torch.no_grad():
        frames = model.predict_frames(_ids(x), t(x_lengths))
    np.testing.assert_array_equal(n(frames), ref.y_lengths)


def test_forward_matches_jax(weights):
    cfg, cfg_j, params, model = weights
    x, x_lengths, y, y_lengths = _batch(8)
    ref = japply(JaxSynthesizer(cfg_j), params, x, x_lengths, y, y_lengths,
                 rngs={"noise": jax.random.PRNGKey(9),
                       "slice": jax.random.PRNGKey(10)}, train=False)
    (r_o, r_mb, r_l, r_attn, r_ids, r_xmask, r_ymask,
     (r_z, r_zp, r_mp, r_logsp, r_mq, r_logsq)) = ref
    eps = np.where(r_ymask > 0, (r_z - r_mq) / np.exp(r_logsq), 0.0).astype(
        np.float32)
    with torch.no_grad():
        (o, o_mb, l_length, attn, ids, x_mask, y_mask, latents) = model(
            _ids(x), t(x_lengths), t(y), t(y_lengths), posterior_eps=t(eps),
            ids_slice=t(r_ids))
    np.testing.assert_array_equal(n(attn), r_attn)
    assert r_attn.sum() == y_lengths.sum()  # one token per frame
    np.testing.assert_array_equal(n(ids), r_ids)
    np.testing.assert_array_equal(n(x_mask), r_xmask)
    np.testing.assert_array_equal(n(y_mask), r_ymask)
    assert_close(n(l_length), r_l, what="l_length")
    for ours, r, what in zip(latents, ref[-1],
                             "z z_p m_p logs_p m_q logs_q".split()):
        assert_close(n(ours), r, what=what)
    assert o.shape == r_o.shape == (2, cfg.segment_size * 256, 1)
    assert rel_l2(n(o), r_o) <= WAV_REL_L2
    assert rel_l2(n(o_mb), r_mb) <= WAV_REL_L2


def test_decode_matches_jax(weights):
    cfg, cfg_j, params, model = weights
    z = np.random.RandomState(11).randn(1, 17, cfg.inter_channels).astype(
        np.float32)
    y_mask = (np.arange(17) < 14)[None, :, None].astype(np.float32)
    r_o = japply(JaxSynthesizer(cfg_j), params, z, None, y_mask,
                 method=JaxSynthesizer.decode)[0]
    with torch.no_grad():
        o = model.decode(t(z), None, t(y_mask))[0]
    assert rel_l2(n(o), r_o) <= WAV_REL_L2


# -- 15: weight bridge -------------------------------------------------------------


def test_state_dict_from_jax_matches_export(weights, tmp_path):
    cfg, cfg_j, params, model = weights
    path = str(tmp_path / "G_export.pth")
    export_torch_generator(params, cfg_j, path)
    exported = load_generator_pth(path)
    ours = state_dict_from_jax(params, cfg)
    assert sorted(ours) == sorted(exported) == sorted(model.state_dict())
    for k, v in ours.items():
        assert v.shape == exported[k].shape, k
        assert torch.equal(v, exported[k].float()), k
    fresh = type(model)(cfg)
    fresh.load_state_dict(exported)  # strict: every key, nothing extra
