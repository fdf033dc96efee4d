"""The library surface the shipped configs do not run, against the JAX
package on the CPU: every `MultiHeadAttention` option (relative tables
shared or a head each, none, `block_length`, the proximal bias and init,
cross-attention), `FFN` with same and causal padding, the transformer
encoder and decoder, `ConvReluNorm`, the timing signals,
`attention_bias_proximal`, `subsequent_mask`, `profile_trace`, and the
top-level and `utils` names.

Each module is built in JAX with `init`, its numpy params are carried to
the port's module by `weights.module_state_dict_from_jax`, and both run
seeded numpy inputs (JAX channels-last, the port [B, C, T]). Widths:
hidden 16, 2 heads, 2 layers. Tolerance: f32 max-abs <= 1e-4.
"""

from __future__ import annotations

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mb_istft_vits_tpu.nn as jnn
import mb_istft_vits_tpu.ops as jops

import mb_istft_vits_torch
import mb_istft_vits_torch.nn as tnn
import mb_istft_vits_torch.ops as tops
from mb_istft_vits_torch import config as tconfig
from mb_istft_vits_torch import utils as tutils
from mb_istft_vits_torch.weights import module_state_dict_from_jax

from tests.torch_port_common import assert_close, cl, n, t

HIDDEN, HEADS, LAYERS, FILTER = 16, 2, 2, 32


def _carry(jmod, tmod, *args, seed=0, edit=None, **kwargs):
    """Init `jmod` on args, optionally edit its params, load them into the
    port's `tmod` (eval mode). Returns the params."""
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed), *args,
                                **kwargs)["params"]
    params = jax.tree.map(np.asarray, params)
    if edit is not None:
        params = edit(params)
    tmod.load_state_dict(module_state_dict_from_jax(params, tmod))
    tmod.eval()
    return params


def _jrun(jmod, params, *args, **kwargs):
    return np.asarray(jax.jit(jmod.apply)({"params": params}, *args,
                                          **kwargs))


def _ragged_mask(lengths, t_max):
    return (np.arange(t_max)[None, :] < np.asarray(lengths)[:, None]
            ).astype(np.float32)


# -- MultiHeadAttention in every option ----------------------------------------

# name: (constructor options, key length or None for self-attention,
#        mask kind)
MHA_CASES = {
    "rel_shared": (dict(), None, "ragged"),
    "rel_per_head": (dict(heads_share=False), None, "ragged"),
    "no_window": (dict(window_size=None), None, None),
    "block_length": (dict(block_length=2), None, "ragged"),
    "block_length_no_window": (dict(window_size=None, block_length=3), None,
                               "ragged"),
    "proximal_bias": (dict(window_size=None, proximal_bias=True), None,
                      "causal"),
    "proximal_init": (dict(window_size=None, proximal_init=True), None,
                      "ragged"),
    "cross": (dict(window_size=None), 7, "cross"),
}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_multi_head_attention_matches_jax(case):
    opts, t_kv, mask_kind = MHA_CASES[case]
    rng = np.random.RandomState(sorted(MHA_CASES).index(case))
    b, t_q = 2, 11
    x = rng.randn(b, t_q, HIDDEN).astype(np.float32)
    ctx = None if t_kv is None else rng.randn(b, t_kv, HIDDEN).astype(
        np.float32)
    q_mask = _ragged_mask([t_q, 8], t_q)
    if mask_kind == "ragged":
        mask = q_mask[:, None, :, None] * q_mask[:, None, None, :]
    elif mask_kind == "causal":
        mask = np.tril(np.ones((t_q, t_q), np.float32))[None, None]
    elif mask_kind == "cross":
        kv_mask = _ragged_mask([t_kv, 4], t_kv)
        mask = q_mask[:, None, :, None] * kv_mask[:, None, None, :]
    else:
        mask = None
    jm = jnn.MultiHeadAttention(HIDDEN, HIDDEN, HEADS, **opts)
    tm = tnn.MultiHeadAttention(HIDDEN, HIDDEN, HEADS, **opts)
    jx = jnp.asarray(x)
    jmask = None if mask is None else jnp.asarray(mask)
    jctx = None if ctx is None else jnp.asarray(ctx)
    params = _carry(jm, tm, jx, jmask, context=jctx)
    if opts.get("window_size", 4) is None:
        assert "emb_rel_k" not in dict(tm.named_parameters())
    ref = _jrun(jm, params, jx, jmask, context=jctx)
    with torch.no_grad():
        ours = tm(cl(x), None if mask is None else t(mask),
                  None if ctx is None else cl(ctx))
    assert_close(n(ours).transpose(0, 2, 1), ref, what=case)


def test_proximal_init_copies_conv_q_into_conv_k():
    """Equal values, distinct tensors (reference attentions.py:141-144)."""
    torch.manual_seed(0)
    m = tnn.MultiHeadAttention(HIDDEN, HIDDEN, HEADS, window_size=None,
                               proximal_init=True)
    assert torch.equal(m.conv_k.weight, m.conv_q.weight)
    assert torch.equal(m.conv_k.bias, m.conv_q.bias)
    assert m.conv_k.weight.data_ptr() != m.conv_q.weight.data_ptr()
    plain = tnn.MultiHeadAttention(HIDDEN, HIDDEN, HEADS, window_size=None)
    assert not torch.equal(plain.conv_k.weight, plain.conv_q.weight)


def test_block_length_and_bias_need_one_length():
    m = tnn.MultiHeadAttention(HIDDEN, HIDDEN, HEADS)  # relative tables
    with pytest.raises(ValueError, match="one length"):
        m(torch.randn(1, HIDDEN, 5), None, torch.randn(1, HIDDEN, 6))


# -- FFN, the encoder and the decoder ------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_ffn_matches_jax(causal):
    rng = np.random.RandomState(20 + causal)
    x = rng.randn(2, 13, HIDDEN).astype(np.float32)
    mask = _ragged_mask([13, 9], 13)[..., None]
    jm = jnn.FFN(HIDDEN, FILTER, 3, causal=causal)
    tm = tnn.FFN(HIDDEN, HIDDEN, FILTER, 3, causal=causal)
    params = _carry(jm, tm, jnp.asarray(x), jnp.asarray(mask))
    ref = _jrun(jm, params, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        ours = tm(cl(x), cl(mask))
    assert_close(n(ours).transpose(0, 2, 1), ref, what=f"causal={causal}")


def test_causal_ffn_sees_no_later_frame():
    torch.manual_seed(1)
    m = tnn.FFN(HIDDEN, HIDDEN, FILTER, 3, causal=True).eval()
    x, mask = torch.randn(1, HIDDEN, 10), torch.ones(1, 1, 10)
    x2 = x.clone()
    x2[..., 6] += 10.0
    with torch.no_grad():
        y1, y2 = m(x, mask), m(x2, mask)
    assert torch.allclose(y1[..., :6], y2[..., :6])
    assert not torch.allclose(y1[..., 6:], y2[..., 6:])


def _decoder_inputs(seed):
    rng = np.random.RandomState(seed)
    b, t_q, t_kv = 2, 12, 7
    x = rng.randn(b, t_q, HIDDEN).astype(np.float32)
    h = rng.randn(b, t_kv, HIDDEN).astype(np.float32)
    return (x, _ragged_mask([t_q, 9], t_q)[..., None], h,
            _ragged_mask([t_kv, 5], t_kv)[..., None])


@pytest.mark.parametrize("stack", ["encoder", "decoder"])
def test_transformer_stack_matches_jax(stack):
    x, x_mask, h, h_mask = _decoder_inputs(30)
    if stack == "encoder":
        jm = jnn.TransformerEncoder(HIDDEN, FILTER, HEADS, LAYERS, 3)
        tm = tnn.TransformerEncoder(HIDDEN, FILTER, HEADS, LAYERS, 3)
        jargs, targs = (x, x_mask), (cl(x), cl(x_mask))
    else:
        jm = jnn.TransformerDecoder(HIDDEN, FILTER, HEADS, LAYERS, 3)
        tm = tnn.TransformerDecoder(HIDDEN, FILTER, HEADS, LAYERS, 3)
        jargs = (x, x_mask, h, h_mask)
        targs = (cl(x), cl(x_mask), cl(h), cl(h_mask))
    jargs = tuple(jnp.asarray(a) for a in jargs)
    params = _carry(jm, tm, *jargs)
    ref = _jrun(jm, params, *jargs)
    with torch.no_grad():
        ours = tm(*targs)
    assert_close(n(ours).transpose(0, 2, 1), ref, what=stack)


def test_transformer_decoder_is_causal():
    """JAX's `tests/test_nn.py` causality test on the port: a change at
    frame 6 leaves the frames before it alone and moves the later ones;
    the memory reaches every frame."""
    torch.manual_seed(2)
    m = tnn.TransformerDecoder(HIDDEN, FILTER, HEADS, LAYERS, 3).eval()
    x, h = torch.randn(1, HIDDEN, 10), torch.randn(1, HIDDEN, 6)
    x_mask, h_mask = torch.ones(1, 1, 10), torch.ones(1, 1, 6)
    x2 = x.clone()
    x2[..., 6] += 10.0
    with torch.no_grad():
        y1 = m(x, x_mask, h, h_mask)
        y2 = m(x2, x_mask, h, h_mask)
        y3 = m(x, x_mask, 2 * h, h_mask)
    assert torch.allclose(y1[..., :6], y2[..., :6], atol=1e-4)
    assert not torch.allclose(y1[..., 6:], y2[..., 6:])
    assert not torch.allclose(y1, y3)


def test_transformer_decoder_uses_the_reference_names():
    names = {k.split(".")[0] for k in tnn.TransformerDecoder(
        HIDDEN, FILTER, HEADS, LAYERS).state_dict()}
    assert names == {"self_attn_layers", "norm_layers_0",
                     "encdec_attn_layers", "norm_layers_1", "ffn_layers",
                     "norm_layers_2"}


# -- ConvReluNorm ----------------------------------------------------------------------


def _random_proj(params):
    rng = np.random.RandomState(41)
    proj = {k: 0.1 * rng.randn(*v.shape).astype(np.float32)
            for k, v in params["proj"].items()}
    return dict(params, proj=proj)


@pytest.mark.parametrize("proj", ["zero_init", "random"])
def test_conv_relu_norm_matches_jax(proj):
    """At init the block is the identity in both (the zero projection);
    with a random projection the stacks themselves are compared."""
    rng = np.random.RandomState(40)
    x = rng.randn(2, 12, HIDDEN).astype(np.float32)
    mask = _ragged_mask([12, 8], 12)[..., None]
    jm = jnn.ConvReluNorm(HIDDEN, HIDDEN, 5, 3)
    tm = tnn.ConvReluNorm(HIDDEN, HIDDEN, HIDDEN, 5, 3)
    params = _carry(jm, tm, jnp.asarray(x), jnp.asarray(mask),
                    edit=_random_proj if proj == "random" else None)
    ref = _jrun(jm, params, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        ours = n(tm(cl(x), cl(mask))).transpose(0, 2, 1)
    assert_close(ours, ref, what=proj)
    if proj == "zero_init":
        assert_close(ours, x * mask, atol=1e-6, what="identity")


def test_conv_relu_norm_identity_at_its_own_init():
    torch.manual_seed(3)
    m = tnn.ConvReluNorm(HIDDEN, HIDDEN, HIDDEN, 5, 3, p_dropout=0.1).eval()
    x, mask = torch.randn(2, HIDDEN, 12), torch.ones(2, 1, 12)
    mask[1, :, 8:] = 0
    with torch.no_grad():
        assert torch.allclose(m(x, mask), x * mask, atol=1e-6)
    with pytest.raises(ValueError, match="n_layers > 1"):
        tnn.ConvReluNorm(HIDDEN, HIDDEN, HIDDEN, 5, 1)


# -- timing signals, the proximal bias, the causal mask ------------------------------


@pytest.mark.parametrize("channels", [8, 7, 2])
def test_timing_signals_match_jax(channels):
    """The port's [B, C, T] against JAX's [B, T, C], transposed; an odd
    channel count ends in one zero channel."""
    length = 9
    rng = np.random.RandomState(50 + channels)
    x = rng.randn(3, length, channels).astype(np.float32)
    sig = tops.get_timing_signal_1d(length, channels)
    assert sig.shape == (1, channels, length)
    assert_close(n(sig).transpose(0, 2, 1),
                 np.asarray(jops.get_timing_signal_1d(length, channels)),
                 what="get")
    if channels % 2:
        assert not n(sig)[0, -1].any()
    assert_close(n(tops.add_timing_signal_1d(cl(x), 0.5, 100.0))
                 .transpose(0, 2, 1),
                 np.asarray(jops.add_timing_signal_1d(jnp.asarray(x), 0.5,
                                                      100.0)), what="add")
    assert_close(n(tops.cat_timing_signal_1d(cl(x))).transpose(0, 2, 1),
                 np.asarray(jops.cat_timing_signal_1d(jnp.asarray(x))),
                 what="cat")
    assert tops.cat_timing_signal_1d(cl(x), axis=2).shape == (
        3, channels, 2 * length)


@pytest.mark.parametrize("length", [1, 6])
def test_proximal_bias_and_subsequent_mask_match_jax(length):
    assert_close(n(tnn.attention_bias_proximal(length)),
                 np.asarray(jnn.attention_bias_proximal(length)),
                 what="bias")
    assert np.array_equal(n(tnn.subsequent_mask(length)),
                          np.asarray(jnn.subsequent_mask(length)))


# -- profile_trace and the exported names ---------------------------------------------


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with tutils.profile_trace(str(tmp_path)) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert any("aten::mm" in e.key for e in prof.key_averages())
    traces = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


@pytest.mark.parametrize("name", ["HParams", "load_hparams"])
def test_top_level_names_are_the_config_module_s(name):
    assert getattr(mb_istft_vits_torch, name) is getattr(tconfig, name)


def test_load_hparams_reads_a_shipped_config():
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "configs", "ljs_mb_istft_vits.json")
    hps = mb_istft_vits_torch.load_hparams(path)
    assert hps.model.hidden_channels == 192


@pytest.mark.parametrize("name", ["enable_nan_debugging",
                                  "plot_alignment_to_numpy",
                                  "plot_spectrogram_to_numpy",
                                  "profile_trace", "summarize"])
def test_utils_exports_the_jax_names(name):
    from mb_istft_vits_torch.utils import observability

    assert getattr(tutils, name) is getattr(observability, name)
