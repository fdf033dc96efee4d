"""Parity of the PyTorch port's model variants with the JAX package on the
CPU: the single-band iSTFT and the multi-stream iSTFT heads, speaker
conditioning (`emb_g` and the `cond` / `cond_layer` convs), copy-synthesis
and voice conversion, and the JAX positional order of the public
`Synthesizer` methods. The serving module on the variants is
tests/test_torch_port_variants_serve.py, the training step of the
multi-stream multi-speaker model tests/test_torch_port_variants_train.py.

Tiny model of torch_port_common (three dilations per resblock); the
multi-speaker cases have 3 speakers and gin 8. Both packages load one
seeded reference-format `.pth`; inputs and noise come from numpy seeds or
are recovered from JAX's draws. Tolerances: f32 max-abs <= 1e-4 per module
output, relative L2 <= 1e-3 on waveforms; alignments, lengths and slice
starts exact.
"""

from __future__ import annotations

import inspect

import jax
import numpy as np
import pytest
import torch

from mb_istft_vits_tpu.models import Synthesizer as JSynth
from mb_istft_vits_tpu.ops import rand_slice_segments as j_rand_slice
from mb_istft_vits_tpu.train.checkpoint import export_torch_generator

from mb_istft_vits_torch.models import Synthesizer
from mb_istft_vits_torch.weights import load_generator_pth, state_dict_from_jax

from tests.torch_port_common import (
    WAV_REL_L2,
    assert_close,
    configs,
    japply,
    make_weights,
    n,
    rel_l2,
    t,
)

HEAD_FLAGS = {"istft": dict(istft_vits=True, mb_istft_vits=False),
              "ms_istft": dict(ms_istft_vits=True, mb_istft_vits=False)}
SPEAKERS = dict(n_speakers=3, gin_channels=8)
# model variants: (head, multi-speaker)
VARIANTS = {"istft": ("istft", False), "ms_istft": ("ms_istft", False),
            "ms_istft_3spk": ("ms_istft", True)}
SID = np.array([2, 0], np.int32)


def _variant_configs(head, multi, **kw):
    return configs(**HEAD_FLAGS[head], **(SPEAKERS if multi else {}), **kw)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request, tmp_path_factory):
    head, multi = VARIANTS[request.param]
    cfg_t, cfg_j = _variant_configs(head, multi)
    params, model = make_weights(tmp_path_factory.mktemp(request.param),
                                 cfg_t, cfg_j)
    return dict(name=request.param, head=head, cfg=cfg_t, cfg_j=cfg_j,
                params=params, model=model, sid=SID if multi else None)


def _batch(seed=0, b=2, t_x=11, t_y=40, spec=513):
    rng = np.random.RandomState(seed)
    x = rng.randint(1, 40, size=(b, t_x)).astype(np.int32)
    x_lengths = np.array([t_x, t_x - 3], np.int32)
    y = (rng.randn(b, t_y, spec) ** 2).astype(np.float32)
    y_lengths = np.array([t_y, t_y - 8], np.int32)
    return x, x_lengths, y, y_lengths


def _ids(x):
    return t(x.astype(np.int64))


def _sid(v):
    return None if v["sid"] is None else t(v["sid"])


def _o_mb_to_jax(o_mb, head):
    """The MS head's zero-stuffed conv input is [B, s, T] in the port and
    channels-last in JAX; the iSTFT head has none."""
    if o_mb is None:
        return None
    return n(o_mb).transpose(0, 2, 1) if head == "ms_istft" else n(o_mb)


def _posterior(m, y, y_lengths, sid, train=False, slice_=False):
    """The first "noise" draw of `Synthesizer.__call__` / `reconstruct` /
    `voice_conversion` (and the first "slice" draw): (z, m_q, logs_q,
    y_mask[, ids_slice])."""
    out = m.enc_q(y, y_lengths, g=m._speaker(sid),
                  noise_rng=m.make_rng("noise"), train=train)
    if slice_:
        _, ids = j_rand_slice(out[0], m.make_rng("slice"), y_lengths,
                              m.cfg.segment_size)
        out = out + (ids,)
    return out


def _eps(z, m_q, logs_q, y_mask):
    """A JAX posterior draw, recovered inside the mask (zero outside)."""
    return np.where(y_mask > 0, (z - m_q) / np.exp(logs_q), 0.0).astype(
        np.float32)


# -- the model, per variant ----------------------------------------------------


def test_weight_bridge_matches_export(variant, tmp_path):
    """state_dict_from_jax gives export_torch_generator's keys and
    tensors, which are the port's own: conv_post or
    multistream_conv_post by head, emb_g and every cond / cond_layer."""
    cfg, params, model = variant["cfg"], variant["params"], variant["model"]
    path = str(tmp_path / "G_export.pth")
    export_torch_generator(params, variant["cfg_j"], path)
    exported = load_generator_pth(path)
    ours = state_dict_from_jax(params, cfg)
    assert sorted(ours) == sorted(exported) == sorted(model.state_dict())
    for k, v in ours.items():
        assert torch.equal(v, exported[k].float()), k
    keys = set(ours)
    assert ("dec.conv_post.weight_v" in keys) == (variant["head"] == "istft")
    assert ("dec.multistream_conv_post.weight_v" in keys) == (
        variant["head"] == "ms_istft")
    assert "dec.multistream_conv_post.bias" not in keys
    multi = variant["sid"] is not None
    for k in ("emb_g.weight", "dp.cond.weight", "enc_q.enc.cond_layer.weight_v",
              "flow.flows.0.enc.cond_layer.weight_v",
              "dec.resblocks.0.cond.bias"):
        assert (k in keys) == multi, k


def test_infer_matches_jax(variant):
    v = variant
    x, x_lengths, _, _ = _batch(6)
    ref = japply(JSynth(v["cfg_j"]), v["params"], x, x_lengths, v["sid"],
                 method=JSynth.infer, rngs={"noise": jax.random.PRNGKey(7)},
                 max_frames=60)
    _, r_zp, r_mp, r_logsp = ref.latents
    eps = ((r_zp - r_mp) / np.exp(r_logsp)).astype(np.float32)
    with torch.no_grad():
        out = v["model"].infer(_ids(x), t(x_lengths), _sid(v), max_frames=60,
                               eps=t(eps))
        frames = v["model"].predict_frames(_ids(x), t(x_lengths), _sid(v))
    np.testing.assert_array_equal(n(out.y_lengths), ref.y_lengths)
    np.testing.assert_array_equal(n(frames), ref.y_lengths)
    np.testing.assert_array_equal(n(out.attn), ref.attn)
    for ours, r, what in zip(out.latents, ref.latents,
                             "z z_p m_p logs_p".split()):
        assert_close(n(ours), r, what=what)
    assert_close(n(out.spec), ref.spec, what="spec")
    assert_close(n(out.phase), ref.phase, what="phase")
    assert out.o.shape == ref.o.shape
    assert rel_l2(n(out.o), ref.o) <= WAV_REL_L2
    if v["head"] == "istft":
        assert out.o_mb is None and ref.o_mb is None
        assert out.spec.dim() == 3  # [B, T', bins]
    else:
        assert rel_l2(_o_mb_to_jax(out.o_mb, v["head"]), ref.o_mb) \
            <= WAV_REL_L2


def test_forward_matches_jax(variant):
    v = variant
    x, x_lengths, y, y_lengths = _batch(8)
    ref = japply(JSynth(v["cfg_j"]), v["params"], x, x_lengths, y, y_lengths,
                 v["sid"], rngs={"noise": jax.random.PRNGKey(9),
                                 "slice": jax.random.PRNGKey(10)},
                 train=False)
    (r_o, r_mb, r_l, r_attn, r_ids, r_xmask, r_ymask,
     (r_z, r_zp, r_mp, r_logsp, r_mq, r_logsq)) = ref
    with torch.no_grad():
        (o, o_mb, l_length, attn, ids, x_mask, y_mask, latents) = v["model"](
            _ids(x), t(x_lengths), t(y), t(y_lengths), _sid(v),
            posterior_eps=t(_eps(r_z, r_mq, r_logsq, r_ymask)),
            ids_slice=t(r_ids))
    np.testing.assert_array_equal(n(attn), r_attn)
    np.testing.assert_array_equal(n(ids), r_ids)
    np.testing.assert_array_equal(n(y_mask), r_ymask)
    assert_close(n(l_length), r_l, what="l_length")
    for ours, r, what in zip(latents, ref[-1],
                             "z z_p m_p logs_p m_q logs_q".split()):
        assert_close(n(ours), r, what=what)
    samples = 4 ** 3 * (4 if v["head"] == "ms_istft" else 1)  # a frame's
    assert o.shape == r_o.shape == (2, v["cfg"].segment_size * samples, 1)
    assert rel_l2(n(o), r_o) <= WAV_REL_L2
    if v["head"] == "istft":
        assert o_mb is None and r_mb is None
    else:
        assert rel_l2(_o_mb_to_jax(o_mb, v["head"]), r_mb) <= WAV_REL_L2


def test_decode_matches_jax(variant):
    v = variant
    z = np.random.RandomState(11).randn(2, 17, v["cfg"].inter_channels
                                        ).astype(np.float32)
    y_mask = (np.arange(17) < 14)[None, :, None].astype(np.float32)
    ref = japply(JSynth(v["cfg_j"]), v["params"], z, v["sid"], y_mask,
                 method=JSynth.decode)
    with torch.no_grad():
        o, o_mb, spec, phase = v["model"].decode(t(z), _sid(v), t(y_mask))
    assert_close(n(spec), ref[2], what="spec")
    assert_close(n(phase), ref[3], what="phase")
    assert rel_l2(n(o), ref[0]) <= WAV_REL_L2


def test_decode_spec_tail_matches_jax(variant):
    v = variant
    rng = np.random.RandomState(3)
    shape = (2, 21, 9) if v["head"] == "istft" else (2, 21, 4, 9)
    spec = np.exp(rng.randn(*shape)).astype(np.float32)
    phase = (np.pi * rng.uniform(-1, 1, shape)).astype(np.float32)
    want = japply(JSynth(v["cfg_j"]), v["params"], spec, phase,
                  method=JSynth.decode_spec_tail)
    with torch.no_grad():
        got = v["model"].decode_spec_tail(t(spec), t(phase))
    assert_close(n(got), want, what="decode_spec_tail")


# -- multi-speaker: speakers matter, copy-synthesis, voice conversion ----------


@pytest.fixture(scope="module")
def speakers(tmp_path_factory):
    cfg_t, cfg_j = _variant_configs("ms_istft", True)
    params, model = make_weights(tmp_path_factory.mktemp("spk"), cfg_t,
                                 cfg_j)
    return cfg_t, cfg_j, params, model


def test_reconstruct_matches_jax(speakers):
    cfg, cfg_j, params, model = speakers
    _, _, y, y_lengths = _batch(12)
    rngs = {"noise": jax.random.PRNGKey(13)}
    r_o, r_mask = japply(JSynth(cfg_j), params, y, y_lengths, SID,
                         method=JSynth.reconstruct, rngs=rngs)
    post = japply(JSynth(cfg_j), params, y, y_lengths, SID,
                  method=_posterior, rngs=rngs)
    with torch.no_grad():
        o, y_mask = model.reconstruct(t(y), t(y_lengths), t(SID),
                                      posterior_eps=t(_eps(*post)))
    np.testing.assert_array_equal(n(y_mask), r_mask)
    assert o.shape == r_o.shape == (2, 40 * 256, 1)
    assert rel_l2(n(o), r_o) <= WAV_REL_L2


def test_voice_conversion_matches_jax(speakers):
    cfg, cfg_j, params, model = speakers
    _, _, y, y_lengths = _batch(14)
    src, tgt = np.array([0, 1], np.int32), np.array([2, 2], np.int32)
    rngs = {"noise": jax.random.PRNGKey(15)}
    r_o, r_mb, r_mask, r_lat = japply(JSynth(cfg_j), params, y, y_lengths,
                                      src, tgt,
                                      method=JSynth.voice_conversion,
                                      rngs=rngs)
    post = japply(JSynth(cfg_j), params, y, y_lengths, src,
                  method=_posterior, rngs=rngs)
    with torch.no_grad():
        o, o_mb, y_mask, latents = model.voice_conversion(
            t(y), t(y_lengths), t(src), t(tgt), posterior_eps=t(_eps(*post)))
    np.testing.assert_array_equal(n(y_mask), r_mask)
    for ours, r, what in zip(latents, r_lat, ("z", "z_p", "z_hat")):
        assert_close(n(ours), r, what=what)
    assert rel_l2(n(o), r_o) <= WAV_REL_L2
    assert rel_l2(n(o_mb).transpose(0, 2, 1), r_mb) <= WAV_REL_L2
    # the target speaker changes the output; a single-speaker model refuses
    with torch.no_grad():
        same, *_ = model.voice_conversion(
            t(y), t(y_lengths), t(src), t(src), posterior_eps=t(_eps(*post)))
    assert rel_l2(n(same), n(o)) > 1e-2
    single, _ = _variant_configs("ms_istft", False)
    with pytest.raises(ValueError, match="multi-speaker"):
        Synthesizer(single).voice_conversion(t(y), t(y_lengths), t(src),
                                             t(tgt))


def test_speaker_changes_the_output_and_one_speaker_ignores_sid(speakers):
    cfg, _, _, model = speakers
    x, x_lengths, _, _ = _batch(16)
    eps = torch.zeros(2, 60, cfg.inter_channels)
    with torch.no_grad():
        a = model.infer(_ids(x), t(x_lengths), t(SID), max_frames=60,
                        eps=eps).o
        b = model.infer(_ids(x), t(x_lengths), t(SID[::-1].copy()),
                        max_frames=60, eps=eps).o
    assert rel_l2(n(a), n(b)) > 1e-2
    single = Synthesizer(_variant_configs("ms_istft", False)[0]).eval()
    assert not hasattr(single, "emb_g")
    with torch.no_grad():
        c = single.infer(_ids(x), t(x_lengths), t(SID), max_frames=60,
                         eps=eps).o
        d = single.infer(_ids(x), t(x_lengths), None, max_frames=60,
                         eps=eps).o
    assert torch.equal(c, d)


# -- the JAX positional order of the Synthesizer methods ----------------------

METHODS = [("forward", "__call__"), ("fake_slice", "fake_slice"),
           ("predict_frames", "predict_frames"), ("infer", "infer"),
           ("infer_z_only", "infer_z_only"), ("decode", "decode"),
           ("reconstruct", "reconstruct"),
           ("voice_conversion", "voice_conversion")]


def _positional(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind is p.POSITIONAL_OR_KEYWORD and p.name != "self"]


@pytest.mark.parametrize("ours,theirs", METHODS)
def test_synthesizer_methods_take_jax_positional_order(ours, theirs):
    """A JAX caller's positional call binds the same parameters in the
    port; the port's extras (draws, generator, mas_force) are
    keyword-only."""
    assert _positional(getattr(Synthesizer, ours)) == \
        _positional(getattr(JSynth, theirs))


def test_jax_style_positional_infer_binds_the_same(speakers):
    """JAX's `infer(x, xl, sid, noise_scale, length_scale, noise_scale_w,
    max_frames)` positionally: noise_scale 0 gives the noise-free decode,
    and the sid is the speaker."""
    cfg, _, _, model = speakers
    x, x_lengths, _, _ = _batch(17)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        pos = model.infer(_ids(x), t(x_lengths), t(SID), 0.0, 1.0, 1.0, 60,
                          generator=gen)
        kw = model.infer(_ids(x), t(x_lengths), sid=t(SID), noise_scale=0.0,
                         max_frames=60, eps=torch.randn(2, 60, 16))
        frames = model.predict_frames(_ids(x), t(x_lengths), t(SID), 1.0)
    assert pos.o.shape == (2, 60 * 256, 1)
    assert torch.equal(pos.o, kw.o)
    assert torch.equal(frames, pos.y_lengths)
    with pytest.raises(ValueError, match="eval mode"):
        model(_ids(x), t(x_lengths), torch.zeros(2, 40, 513),
              torch.tensor([40, 32]), t(SID), True)
