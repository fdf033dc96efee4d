"""Module-by-module parity of the PyTorch port with the JAX package on the
CPU: layers, blocks, attention, flows, segments, iSTFT and PQMF, config
and text frontend. Tolerance: f32 max-abs <= 1e-4 (torch_port_common.ATOL)
unless a test states another; integer and boolean results are exact."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mb_istft_vits_tpu.nn as jnn
from mb_istft_vits_tpu.nn.layers import get_padding as j_get_padding
from mb_istft_vits_tpu.config import Config as JaxConfig
from mb_istft_vits_tpu.dsp.pqmf import PQMFBank, _pqmf_filters as j_filters
from mb_istft_vits_tpu.dsp.stft import istft as j_istft
from mb_istft_vits_tpu.nn.attention import _abs_to_rel as j_abs_to_rel
from mb_istft_vits_tpu.nn.attention import _rel_to_abs as j_rel_to_abs
from mb_istft_vits_tpu.nn.flows import ResidualCouplingLayer as JCoupling
from mb_istft_vits_tpu.ops import segments as jseg
from mb_istft_vits_tpu.text import frontend_ids as j_frontend_ids

from mb_istft_vits_torch.config import Config as TorchConfig
from mb_istft_vits_torch.dsp.pqmf import PQMF, _pqmf_filters as t_filters
from mb_istft_vits_torch.dsp.stft import istft as t_istft
from mb_istft_vits_torch.nn import ResBlock2, flip_channels
from mb_istft_vits_torch.nn.attention import _abs_to_rel, _rel_to_abs
from mb_istft_vits_torch.nn.layers import get_padding, leaky_relu
from mb_istft_vits_torch.ops import segments as tseg
from mb_istft_vits_torch.text import frontend_ids as t_frontend_ids

from tests.torch_port_common import (
    assert_close,
    asdict,
    cl,
    configs,
    japply,
    make_weights,
    n,
    t,
)

FLAGSHIP = "configs/ljs_mb_istft_vits.json"
FILELIST = "filelists/ljs_audio_text_test_filelist.txt.cleaned"


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    cfg_t, cfg_j = configs()
    params, model = make_weights(tmp_path_factory.mktemp("w"), cfg_t, cfg_j)
    return cfg_t, params, model


def _x(rng, b=2, t_len=23, c=16):
    """numpy [B, T, C] activations and a ragged [B, T, 1] mask."""
    x = rng.randn(b, t_len, c).astype(np.float32)
    mask = (np.arange(t_len)[None, :, None]
            < np.array([t_len, t_len - 6])[:, None, None]).astype(np.float32)
    return x, mask


# -- 1, 2: config and text ---------------------------------------------------


def test_config_and_frontend_match_jax():
    jc, tc = JaxConfig.from_json(FLAGSHIP), TorchConfig.from_json(FLAGSHIP)
    assert asdict(tc.model) == asdict(jc.model)
    assert asdict(tc.data) == asdict(jc.data)
    d = tc.data
    with open(FILELIST, encoding="utf-8") as f:
        texts = [line.rstrip("\n").split("|")[-1] for line in f][:50]
    for text in texts:
        assert t_frontend_ids(text, d.text_module, d.text_cleaners,
                              d.add_blank, d.cleaned_text) == \
            j_frontend_ids(text, d.text_module, d.text_cleaners,
                           d.add_blank, d.cleaned_text)


# -- 3: layers ----------------------------------------------------------------


@pytest.mark.parametrize("which", ["plain", "weight_norm", "transpose",
                                   "layernorm"])
def test_layers_match_flax(weights, which):
    cfg, params, model = weights
    rng = np.random.RandomState(3)
    if which == "plain":  # 1x1 conv with bias
        x, _ = _x(rng)
        ours = model.enc_p.proj(cl(x))
        ref = japply(jnn.Conv1d(2 * cfg.inter_channels, 1),
                     params["enc_p"]["proj"], x)
    elif which == "weight_norm":  # k=7, padding 3
        x, _ = _x(rng)
        ours = model.dec.conv_pre(cl(x))
        ref = japply(jnn.Conv1d(cfg.upsample_initial_channel, 7, padding=3,
                                weight_norm=True),
                     params["dec"]["trunk"]["conv_pre"], x)
    elif which == "transpose":  # stride 4, k=16, g over input channels
        x, _ = _x(rng, c=cfg.upsample_initial_channel)
        ours = model.dec.ups[0](cl(x))
        ref = japply(jnn.ConvTranspose1d(cfg.upsample_initial_channel // 2,
                                         16, stride=4, padding=6,
                                         weight_norm=True),
                     params["dec"]["trunk"]["ups_0"], x)
    else:
        x, _ = _x(rng)
        ours = model.enc_p.encoder.norm_layers_1[0](cl(x))
        ref = japply(jnn.LayerNorm(),
                     params["enc_p"]["encoder"]["norm_layers_1_0"], x)
    assert_close(n(ours).transpose(0, 2, 1), ref, what=which)


def test_activation_and_padding_helpers():
    x = np.linspace(-3, 3, 41).astype(np.float32)
    assert_close(n(leaky_relu(t(x))), jax.nn.leaky_relu(x, 0.1), atol=0)
    assert_close(n(leaky_relu(t(x), 0.01)), jax.nn.leaky_relu(x, 0.01),
                 atol=0)
    for k in (3, 7, 11):
        for d in (1, 3, 5):
            assert get_padding(k, d) == j_get_padding(k, d)


# -- 4: blocks ----------------------------------------------------------------


def test_resblock1_matches_flax(weights):
    cfg, params, model = weights
    x, _ = _x(np.random.RandomState(4), c=cfg.upsample_initial_channel // 2)
    ours = model.dec.resblocks[0](cl(x))
    ref = japply(jnn.ResBlock1(cfg.upsample_initial_channel // 2, 3,
                               (1, 3, 5)),
                 params["dec"]["trunk"]["resblocks_0"], x)
    assert_close(n(ours).transpose(0, 2, 1), ref)


def test_resblock2_matches_flax():
    rng = np.random.RandomState(5)
    ch, dil = 8, (1, 3)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        block = ResBlock2(ch, 3, dil)
    p = {f"convs_{j}": {"v": n(c.weight_v).transpose(2, 1, 0),
                        "g": n(c.weight_g).reshape(-1), "bias": n(c.bias)}
         for j, c in enumerate(block.convs)}
    x, mask = _x(rng, c=ch)
    ours = block(cl(x), cl(mask))
    ref = japply(jnn.ResBlock2(ch, 3, dil), p, x, mask)
    assert_close(n(ours).transpose(0, 2, 1), ref)


def test_wn_matches_flax(weights):
    cfg, params, model = weights
    x, mask = _x(np.random.RandomState(6))
    ours = model.enc_q.enc(cl(x), cl(mask))
    ref = japply(jnn.WN(cfg.hidden_channels, 5, 1, 16),
                 params["enc_q"]["enc"], x, mask)
    assert_close(n(ours).transpose(0, 2, 1), ref)


# -- 5: attention ---------------------------------------------------------------


@pytest.mark.parametrize("length", [1, 3, 5, 12])
def test_rel_abs_shuffles_match_jax(length):
    rng = np.random.RandomState(length)
    rel = rng.randn(2, 3, length, 2 * length - 1).astype(np.float32)
    absx = rng.randn(2, 3, length, length).astype(np.float32)
    assert_close(n(_rel_to_abs(t(rel))), j_rel_to_abs(jnp.asarray(rel)),
                 atol=0)
    assert_close(n(_abs_to_rel(t(absx))), j_abs_to_rel(jnp.asarray(absx)),
                 atol=0)


@pytest.mark.parametrize("which", ["attention", "ffn", "encoder"])
def test_attention_modules_match_flax(weights, which):
    cfg, params, model = weights
    # T=23 > the +-4 window: exercises the padded relative-embedding table
    x, mask = _x(np.random.RandomState(7), t_len=23)
    enc = params["enc_p"]["encoder"]
    hc, fc = cfg.hidden_channels, cfg.filter_channels
    if which == "attention":
        attn_mask = mask[:, None, :, 0][:, :, None, :] * mask[:, None, :, :1]
        ours = model.enc_p.encoder.attn_layers[0](cl(x), t(attn_mask))
        ref = japply(jnn.MultiHeadAttention(hc, hc, cfg.n_heads,
                                            cfg.p_dropout, window_size=4),
                     enc["attn_layers_0"], x, attn_mask)
    elif which == "ffn":
        ours = model.enc_p.encoder.ffn_layers[0](cl(x), cl(mask))
        ref = japply(jnn.FFN(hc, fc, cfg.kernel_size, cfg.p_dropout),
                     enc["ffn_layers_0"], x, mask)
    else:
        ours = model.enc_p.encoder(cl(x), cl(mask))
        ref = japply(jnn.TransformerEncoder(hc, fc, cfg.n_heads, cfg.n_layers,
                                            cfg.kernel_size, cfg.p_dropout),
                     enc, x, mask)
    assert_close(n(ours).transpose(0, 2, 1), ref, what=which)


# -- 6: flows -------------------------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True])
def test_coupling_layer_matches_flax(weights, reverse):
    cfg, params, model = weights
    x, mask = _x(np.random.RandomState(8))
    layer = model.flow.flows[0]
    jmod = JCoupling(cfg.inter_channels, cfg.hidden_channels, 5, 1, 4,
                     mean_only=True)
    p = params["flow"]["coupling_0"]
    if reverse:
        ours = layer(cl(x), cl(mask), reverse=True)
        ref = japply(jmod, p, x, mask, reverse=True)
    else:
        ours, logdet = layer(cl(x), cl(mask))
        ref, ref_logdet = japply(jmod, p, x, mask)
        assert_close(n(logdet), ref_logdet)
    assert_close(n(ours).transpose(0, 2, 1), ref)
    assert np.abs(ref - x).max() > 1e-3  # the coupling is not the identity
    assert_close(n(flip_channels(cl(x))).transpose(0, 2, 1), x[..., ::-1],
                 atol=0)


# -- 7: segments ------------------------------------------------------------------


def test_segments_match_jax():
    rng = np.random.RandomState(9)
    lengths = np.array([7, 1, 12], np.int32)
    assert np.array_equal(n(tseg.sequence_mask(t(lengths), 12)),
                          np.asarray(jseg.sequence_mask(jnp.asarray(lengths),
                                                        12)))
    dur = rng.randint(0, 4, size=(3, 9)).astype(np.float32)
    y_len = np.minimum(dur.sum(1), 20).astype(np.int32)
    x_len = np.array([9, 6, 3])
    dur = dur * (np.arange(9)[None] < x_len[:, None])
    mask = ((np.arange(20)[None, :, None] < y_len[:, None, None])
            & (np.arange(9)[None, None, :] < x_len[:, None, None])
            ).astype(np.float32)
    assert np.array_equal(
        n(tseg.generate_path(t(dur), t(mask))),
        np.asarray(jseg.generate_path(jnp.asarray(dur), jnp.asarray(mask))))

    x = rng.randn(3, 30, 5).astype(np.float32)
    ids = np.array([0, 13, 22], np.int32)  # 22 + 8 > 30: clamped like JAX
    ours = tseg.slice_segments(cl(x), t(ids), 8)
    ref = jseg.slice_segments(jnp.asarray(x), jnp.asarray(ids), 8)
    assert_close(n(ours).transpose(0, 2, 1), ref, atol=0)
    seg, ids_t = tseg.rand_slice_segments(cl(x), torch.Generator()
                                          .manual_seed(0),
                                          t(np.array([30, 20, 8])), 8)
    assert seg.shape == (3, 5, 8)
    assert np.all(n(ids_t) >= 0) and np.all(n(ids_t) <= [22, 12, 0])


# -- 9, 10: iSTFT and PQMF --------------------------------------------------------


def test_istft_matches_jax():
    """JAX `istft` runs `istft_riq`, the decoder's iSTFT."""
    rng = np.random.RandomState(10)
    mag = np.exp(rng.randn(3, 9, 37)).astype(np.float32)  # n_fft 16: 9 bins
    phase = (np.pi * np.sin(rng.randn(3, 9, 37))).astype(np.float32)
    ours = t_istft(t(mag), t(phase), 16, 4, 16)
    ref = np.asarray(j_istft(jnp.asarray(mag), jnp.asarray(phase), 16, 4, 16))
    assert ours.shape == ref.shape == (3, 36 * 4)
    assert_close(n(ours), ref)


def test_pqmf_synthesis_matches_jax():
    for a, b in zip(t_filters(4, 62, 0.15, 9.0), j_filters(4, 62, 0.15, 9.0)):
        np.testing.assert_array_equal(a, b)
    x = np.random.RandomState(11).randn(2, 4, 300).astype(np.float32)
    ours = PQMF(4).synthesis_bm(t(x))  # [B, 1, T]
    ref = np.asarray(PQMFBank(4).synthesis_bm(jnp.asarray(x)))  # [B, T, 1]
    assert_close(n(ours).transpose(0, 2, 1), ref)
