"""bf16 serving and the rest of `SynthesisModule`'s constructor on the
CPU: the port's `compute_dtype=torch.bfloat16` module against the JAX
package's `compute_dtype=jnp.bfloat16` on the same `.pth` (the flagship
config shrunk to the tiny width), against the port's own f32 module, and
`mesh` / `aot_cache_dir`.

Knobs are noise-free (noise_scale=0), so neither package draws. The
port runs the iSTFT and everything after it in f32, where JAX runs bf16
DFT matmuls, and rounds its bf16 activations op by op, where XLA keeps
fused chains in f32; so the two bf16 models agree to a few bf16 ulps, not
bit for bit. Per-token frames are ceil of the bf16 exp(logw) in both,
so a token whose exp(logw) lies within those ulps of an integer can take
another frame count: these weights put the blanks' logw at 2^-8, whose
exp is a hair above a bf16 rounding midpoint, and XLA's exp rounds it to
1.0 where torch's gives 1.0078 (one frame against two).
The tests hold: the duration predictor's bf16 logw within 0.02 of JAX's
and frames equal wherever a token is clear of such a boundary; the whole
request at JAX's bf16 durations (the port's predictor returns the log of
JAX's frames less a half): frames equal, correlation > 0.999; the decoder on the same
latents > 0.999 against JAX bf16 and > 0.99 against the port's f32
(`tests/test_infer.py` holds 0.98 for chunked decodes).
"""

from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mb_istft_vits_torch.config import Config as TorchConfig
from mb_istft_vits_torch.infer import synthesis as port
from mb_istft_vits_tpu.config import Config as JaxConfig
from mb_istft_vits_tpu.infer import synthesis as ref

from torch_port_data import MS_CONFIG, write_tiny_config
from tests.torch_port_common import make_weights

TEXTS = ["ðə kwˈɪk bɹˈaʊn fˈɑːks, dʒˈʌmps ˌoʊvɚ ðə lˈeɪzi dˈɑːɡ.",
         "həlˈoʊ wˈɜːld.",
         "ɪn ðə jˈɪɹ wˌʌn θˈaʊzənd ˈeɪt hˈʌndɹɪd ənd fˈɔːɹti."]
QUIET = dict(noise_scale=0.0, seed=0)
LOGW_ATOL = 0.02  # about two bf16 ulps of logw in [1, 2)


def _fresh(*modules):
    """Frame buckets from the duration probe, in every module."""
    for m in modules:
        m._frames_per_token, m._ratio_observed = 3.0, False


def _corr(a, b):
    return float(np.corrcoef(a, b)[0, 1])


@pytest.fixture(scope="module")
def modules(tmp_path_factory):
    """Port bf16, port f32 and JAX bf16 on one tiny config and .pth."""
    d = tmp_path_factory.mktemp("bf16")
    path = write_tiny_config(str(d))
    make_weights(d, TorchConfig.from_json(path).model,
                 JaxConfig.from_json(path).model)
    pth = str(d / "G_0.pth")
    return {"port_bf16": port.SynthesisModule(path, pth, None, 0,
                                              torch.bfloat16, device="cpu"),
            "port_f32": port.SynthesisModule(path, pth, device="cpu"),
            "jax_bf16": ref.SynthesisModule(path, pth, None, 0,
                                            jnp.bfloat16),
            "path": path, "pth": pth}


def _jax_duration_head(jm, x, xl):
    """JAX bf16 (logw [T], frames [T]) at the padded ids x [1, T], the
    frames as its serving programs compute them: jitted, with an f32
    length_scale."""

    def head(m, x, xl, length_scale):
        hx, _, _, x_mask = m.enc_p(x, xl, train=False)
        logw = m.dp(hx, x_mask, g=None)
        return logw, jnp.ceil(jnp.exp(logw) * x_mask * length_scale)

    logw, w = jax.jit(lambda p, *a: jm.model.apply(
        {"params": p}, *a, method=head))(
        jm.params, jnp.asarray(x), jnp.asarray(xl),
        jnp.asarray(1.0, jnp.float32))
    return (np.asarray(logw.astype(jnp.float32))[0, :, 0],
            np.asarray(w.astype(jnp.float32))[0, :, 0])


def _port_duration_head(pm, x, xl):
    """The port's (logw [T], frames [T]) at the padded ids x [1, T]."""
    m = pm.model
    with torch.no_grad():
        h, _, _, x_mask = m.enc_p(torch.from_numpy(x).long(),
                                  torch.from_numpy(xl).long())
        logw = m.dp(h, x_mask, None)
        w = torch.ceil(torch.exp(logw).float() * x_mask)
    return logw.float().numpy()[0, 0], w.float().numpy()[0, 0]


def _padded(sm, text):
    ids = sm.text_to_ids(text)
    x = np.zeros((1, port._next_bucket(len(ids), sm.TEXT_BUCKETS)), np.int32)
    x[0, :len(ids)] = ids
    return x, np.asarray([len(ids)], np.int32), len(ids)


@pytest.mark.parametrize("text", TEXTS)
def test_bf16_duration_predictor_matches_jax_bf16(modules, text):
    ours, theirs = modules["port_bf16"], modules["jax_bf16"]
    x, xl, n_ids = _padded(ours, text)
    jl, jw = (v[:n_ids] for v in _jax_duration_head(theirs, x, xl))
    pl, pw = (v[:n_ids] for v in _port_duration_head(ours, x, xl))
    assert np.abs(pl - jl).max() <= LOGW_ATOL
    # a token may take other frames only where JAX's own exp(logw) lies
    # within the logw tolerance of a frame boundary
    near = (np.ceil(np.exp(jl - LOGW_ATOL))
            != np.ceil(np.exp(jl + LOGW_ATOL)))
    assert not ((pw != jw) & ~near).any()


@pytest.mark.parametrize("text", TEXTS)
def test_bf16_matches_jax_bf16_at_jax_durations(modules, text,
                                                monkeypatch):
    ours, theirs = modules["port_bf16"], modules["jax_bf16"]
    x, xl, _ = _padded(ours, text)
    _, jw = _jax_duration_head(theirs, x, xl)
    # ceil(exp(log(w - 0.5))) is w, clear of any rounding
    logw = torch.log(torch.from_numpy(np.where(jw > 0, jw - 0.5, 1.0))
                     ).to(torch.bfloat16)[None, None]
    monkeypatch.setattr(ours.model.dp, "forward",
                        lambda h, x_mask, g=None: logw * x_mask)
    _fresh(ours, theirs)
    a, ta = ours.synthesize(text, **QUIET)
    b, tb = theirs.synthesize(text, **QUIET)
    assert ta["frame_bucket"] == tb["frame_bucket"]
    assert a.size == b.size > 0  # equal frames
    assert _corr(a, b) > 0.999


@pytest.mark.parametrize("text", TEXTS)
def test_bf16_decoder_against_jax_bf16_and_the_ports_f32(modules, text):
    """The decoder (trunk in bf16, the tail in f32) of each module on the
    same latents: the f32 module's noise-free z."""
    low, full = modules["port_bf16"], modules["port_f32"]
    theirs = modules["jax_bf16"]
    _fresh(full)
    z, y_len, _ = full.prepare_shared_latents(text, **QUIET)
    wav = {name: m.infer_z_only(z) for name, m in
           (("port_bf16", low), ("port_f32", full), ("jax_bf16", theirs))}
    assert {w.size for w in wav.values()} == {y_len * 256}
    assert _corr(wav["port_bf16"], wav["jax_bf16"]) > 0.999
    assert _corr(wav["port_bf16"], wav["port_f32"]) > 0.99


def test_bf16_pcm_is_f32_on_the_int16_grid_and_the_tail_stays_f32(modules):
    sm = modules["port_bf16"]
    dtypes = {name: v.dtype for name, v in
              [*sm.model.named_parameters(), *sm.model.named_buffers()]
              if v.is_floating_point()}
    tail = {k for k in dtypes if k.startswith("dec.pqmf.")}
    assert tail and all(dtypes[k] == torch.float32 for k in tail)
    assert all(v == torch.bfloat16 for k, v in dtypes.items()
               if k not in tail)
    _fresh(sm)
    audio, _ = sm.synthesize(TEXTS[0], **QUIET)
    pcm = audio * 32767.0
    assert audio.dtype == np.float32 and np.isfinite(audio).all()
    np.testing.assert_array_equal(pcm, np.round(pcm))
    # the other routes: latents back as f32, chunked decodes, a batch
    z, y_len, _ = sm.prepare_shared_latents(TEXTS[0], **QUIET)
    assert z.dtype == np.float32 and z.shape[0] == y_len
    whole = sm.infer_z_only(z)
    for out in (sm.decode_spec_join(z),
                np.concatenate(list(sm.stream_from_latents(z)))):
        assert out.size == whole.size and _corr(out, whole) > 0.98
    rows, _ = sm.synthesize_batch(TEXTS, noise_scale=0.0)
    assert all(r.dtype == np.float32 and np.isfinite(r).all() for r in rows)


def test_bf16_multistream_head(tmp_path):
    """The MS head's learned synthesis conv stays f32 beside a bf16
    trunk; bf16 against f32 > 0.99 for a speaker, on the same latents."""
    path = write_tiny_config(str(tmp_path), MS_CONFIG)
    low = port.SynthesisModule(path, None, None, 1, torch.bfloat16,
                               device="cpu")
    full = port.SynthesisModule(path, None, None, 1, device="cpu")
    conv = low.model.dec.multistream_conv_post
    assert conv.weight_v.dtype == conv.weight_g.dtype == torch.float32
    z, _, _ = full.prepare_shared_latents("k o N n i t i w a sp [ a: ]", 3,
                                          **QUIET)
    a, b = low.infer_z_only(z, 3), full.infer_z_only(z, 3)
    assert a.size == b.size and _corr(a, b) > 0.99


def test_synthesis_module_keeps_jax_positional_order():
    ours = inspect.signature(port.SynthesisModule.__init__).parameters
    theirs = inspect.signature(ref.SynthesisModule.__init__).parameters
    assert list(ours)[:8] == list(theirs)
    assert ours["compute_dtype"].default is torch.float32
    assert ours["mesh"].default is None
    assert ours["aot_cache_dir"].default is None
    assert ours["device"].kind is inspect.Parameter.KEYWORD_ONLY
    with pytest.raises(TypeError, match="compute_dtype"):
        port.SynthesisModule("unused.json", None, None, 0, "cpu")


def test_mesh_of_one_device_is_a_no_op_and_a_larger_one_raises(modules):
    path, pth = modules["path"], modules["pth"]
    base = modules["port_f32"]
    _fresh(base)
    want, _ = base.synthesize(TEXTS[1], **QUIET)
    for mesh in (None, [torch.device("cpu")]):
        sm = port.SynthesisModule(path, pth, None, 0, torch.float32, mesh,
                                  device="cpu")
        assert sm.mesh is None
        np.testing.assert_array_equal(sm.synthesize(TEXTS[1], **QUIET)[0],
                                      want)
    # a larger mesh serves now (the serving mesh): a request is the
    # single-device module's; it no longer raises
    sm = port.SynthesisModule(path, pth, None, 0, torch.float32,
                              ["cpu", "cpu"], device="cpu")
    assert len(sm.mesh) == 2
    np.testing.assert_array_equal(sm.synthesize(TEXTS[1], **QUIET)[0], want)


def test_aot_cache_dir_is_accepted(modules, tmp_path):
    sm = port.SynthesisModule(modules["path"], modules["pth"], None, 0,
                              torch.float32, None, str(tmp_path / "aot"),
                              device="cpu")
    assert sm.aot_cache_dir == str(tmp_path / "aot")
    _fresh(sm)
    audio, _ = sm.synthesize(TEXTS[1], **QUIET)
    assert audio.size > 0 and not (tmp_path / "aot").exists()
