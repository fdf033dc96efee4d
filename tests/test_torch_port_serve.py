"""Serving-layer parity of the PyTorch port with the JAX package on the
CPU: `infer/synthesis.py:SynthesisModule` of both, on the flagship config
shrunk to the tiny width of torch_port_data.py, loading one
reference-format `G_0.pth` (torch_port_common.make_weights), with the
buckets shrunk to (32, 64) / (64, 128, 256) as in tests/test_infer.py.

Host logic (buckets, chunk plans, the long-text split, the shift
searches, the overlap-add join, phrase boundaries) is held exact; z and
the spectrogram tail within 1e-4; waveforms within 1e-3 relative L2 at
equal frame buckets and lengths. Knobs are noise-free (noise_scale=0),
so both packages draw nothing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from mb_istft_vits_torch.config import Config as TorchConfig
from mb_istft_vits_torch.infer import synthesis as port
from mb_istft_vits_tpu.config import Config as JaxConfig
from mb_istft_vits_tpu.infer import synthesis as ref
from mb_istft_vits_tpu.models import Synthesizer as JaxSynthesizer

from torch_port_data import write_tiny_config
from tests.torch_port_common import (
    WAV_REL_L2,
    assert_close,
    japply,
    make_weights,
    n,
    rel_l2,
    t,
)

TEXT = "ðə kwˈɪk bɹˈaʊn fˈɑːks, dʒˈʌmps ˌoʊvɚ ðə lˈeɪzi dˈɑːɡ."
TEXTS = [TEXT, "həlˈoʊ wˈɜːld.", "ðə kwˈɪk bɹˈaʊn."]


def _shrink(m):
    m.TEXT_BUCKETS = (32, 64)
    m.FRAME_BUCKETS = (64, 128, 256)
    return m


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(port module, JAX module) on the same tiny config and .pth."""
    d = tmp_path_factory.mktemp("serve")
    path = write_tiny_config(str(d))
    make_weights(d, TorchConfig.from_json(path).model,
                 JaxConfig.from_json(path).model)
    pth = str(d / "G_0.pth")
    ours = _shrink(port.SynthesisModule(path, pth, device="cpu"))
    theirs = _shrink(ref.SynthesisModule(path, checkpoint_path=pth))
    return ours, theirs


def _fresh(*modules):
    """Reset the adaptive frames-per-token state, so both packages pick
    the frame bucket from the duration probe."""
    for m in modules:
        m._frames_per_token, m._ratio_observed = 3.0, False


@pytest.fixture(scope="module")
def jax_z(pair):
    _, theirs = pair
    _fresh(theirs)
    _, z, _ = theirs.synthesize_with_z(TEXT, noise_scale=0.0, seed=0)
    return z


# -- host logic: exact --------------------------------------------------------


def _host_cases():
    rng = np.random.RandomState(0)
    a, b = rng.randn(64), rng.randn(64)
    fa, fb = np.exp(rng.randn(12, 4, 9)), np.exp(rng.randn(12, 4, 9))
    return {
        "next_bucket": lambda m, mod: [
            mod._next_bucket(k, (32, 64, 128), granule=g)
            for k in (0, 1, 32, 33, 128, 129, 1000) for g in (8, 64)],
        "chunk_plan": lambda m, mod: [
            m._chunk_plan(tt, c, o) for tt in (0, 1, 63, 64, 200)
            for c, o in ((16, 4), (64, 8), (16, 0))],
        "chunk_plan_growing": lambda m, mod: [
            m._chunk_plan_growing(tt, c, o, cap) for tt in (0, 5, 66, 700)
            for c, o, cap in ((8, 4, 64), (64, 8, 512))],
        "split_long_ids": lambda m, mod: _split(m),
        "best_shift": lambda m, mod: [
            m._best_shift(a, b, s, lo, hi) for s in (4, 16)
            for lo, hi in ((None, None), (-3, 10), (2, 5))],
        "best_frame_shift": lambda m, mod: [
            m._best_frame_shift(fa, fb, s, lo, hi) for s in (2, 4)
            for lo, hi in ((None, None), (-1, 3), (3, 1))],
        "ola_join": lambda m, mod: _join(m, rng_seed=1),
        "phrase_frame_boundaries": lambda m, mod: m.phrase_frame_boundaries(
            TEXT, np.random.RandomState(2).randint(
                0, 5, size=len(m.text_to_ids(TEXT))).astype(np.float32)),
    }


def _split(m):
    old = m.MAX_TEXT_TOKENS
    m.MAX_TEXT_TOKENS = 10
    try:
        ids = m.text_to_ids(TEXT)
        plain = np.full(25, ids[1])  # no boundary: hard splits
        return [[p.tolist() for p in m._split_long_ids(x)]
                for x in (ids, plain, ids[:10])]
    finally:
        m.MAX_TEXT_TOKENS = old


def _join(m, rng_seed):
    rng = np.random.RandomState(rng_seed)
    out = []
    for t_total, plan, ov in ((50, m._chunk_plan(50, 16, 4), 4),
                              (70, m._chunk_plan_growing(70, 8, 4, 64), 4),
                              (40, m._chunk_plan(40, 16, 0), 0)):
        wavs = []
        for i, (pos, lo, hi) in enumerate(plan):
            nxt = plan[i + 1][0] if i + 1 < len(plan) else t_total
            win = (nxt - pos) + 2 * ov  # the decoded window's frames
            wavs.append(rng.randn(win * m.hop_length).astype(np.float32))
        for xcorr in (False, True):
            out.append(np.concatenate(list(m._ola_join(
                plan, iter(wavs), t_total, ov, xcorr, 32))))
    return out


@pytest.mark.parametrize("case", sorted(_host_cases()))
def test_host_logic_is_exact(pair, case):
    ours, theirs = pair
    fn = _host_cases()[case]
    got, want = fn(ours, port), fn(theirs, ref)
    if case == "ola_join":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        assert got == want


def test_text_to_ids_cleaned_override(pair):
    """`cleaned=False` runs the config's cleaners, as in JAX; the cache
    keys on (text, cleaned)."""
    ours, theirs = pair
    raw = "Hello,   World!"
    for m in pair:
        m.data_cfg = dataclasses.replace(m.data_cfg,
                                         text_cleaners=("basic_cleaners",))
    try:
        got = ours.text_to_ids(raw, cleaned=False)
        np.testing.assert_array_equal(got, theirs.text_to_ids(raw,
                                                              cleaned=False))
        assert not np.array_equal(got, ours.text_to_ids(raw, cleaned=True))
        assert ours.text_to_ids(raw, cleaned=False) is got
    finally:
        for m in pair:
            m.data_cfg = dataclasses.replace(
                m.data_cfg, text_cleaners=("english_cleaners2",))


# -- model paths ------------------------------------------------------------


def test_decode_spec_tail_matches_jax(pair):
    ours, theirs = pair
    rng = np.random.RandomState(3)
    spec = np.exp(rng.randn(2, 21, 4, 9)).astype(np.float32)
    phase = (np.pi * rng.uniform(-1, 1, (2, 21, 4, 9))).astype(np.float32)
    want = japply(JaxSynthesizer(theirs.cfg), theirs.params, spec, phase,
                  method=JaxSynthesizer.decode_spec_tail)
    got = ours.model.decode_spec_tail(t(spec), t(phase))
    assert_close(n(got), want, what="decode_spec_tail")


def test_synthesize_matches_jax(pair):
    ours, theirs = pair
    _fresh(ours, theirs)
    got, tg = ours.synthesize(TEXT, noise_scale=0.0, seed=0)
    want, tw = theirs.synthesize(TEXT, noise_scale=0.0, seed=0)
    assert got.dtype == want.dtype == np.float32
    assert tg["frame_bucket"] == tw["frame_bucket"]
    assert got.shape == want.shape and len(got) % ours.hop_length == 0
    assert set(tg) == set(tw)
    assert rel_l2(got, want) <= WAV_REL_L2


def test_synthesize_with_z_matches_jax(pair, jax_z):
    ours, _ = pair
    _fresh(ours)
    _, z, _ = ours.synthesize_with_z(TEXT, noise_scale=0.0, seed=0)
    assert_close(z, jax_z, what="z")


@pytest.mark.parametrize("path", ["decode_chunks_batched",
                                  "stream_from_latents",
                                  "decode_spec_join",
                                  "decode_spec_join_batched"])
def test_chunked_decode_matches_jax(pair, jax_z, path):
    kw = dict(chunk_frames=16, overlap_frames=4)
    outs = []
    for m in pair:
        if path == "stream_from_latents":
            outs.append(np.concatenate(list(m.stream_from_latents(jax_z,
                                                                  **kw))))
        elif path == "decode_spec_join_batched":
            outs.append(m.decode_spec_join(jax_z, batched=True, **kw))
        else:
            outs.append(getattr(m, path)(jax_z, **kw))
    got, want = outs
    assert got.shape == want.shape == (len(jax_z) * 256,)
    assert rel_l2(got, want) <= WAV_REL_L2


def test_synthesize_batch_matches_jax(pair):
    ours, theirs = pair
    got, _ = ours.synthesize_batch(TEXTS, noise_scale=0.0)
    want, _ = theirs.synthesize_batch(TEXTS, noise_scale=0.0)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_l2(g, w) <= WAV_REL_L2


def test_long_text_route_matches_jax(pair):
    ours, theirs = pair
    long_text = " ".join([TEXT] * 3)
    outs = []
    for m in pair:
        _fresh(m)
        old, m.MAX_TEXT_TOKENS = m.MAX_TEXT_TOKENS, 48
        try:
            outs.append(m.synthesize(long_text, noise_scale=0.0, seed=0))
        finally:
            m.MAX_TEXT_TOKENS = old
    (got, tg), (want, tw) = outs
    assert tg["pieces"] == tw["pieces"] > 1
    assert tg["frame_bucket"] == tw["frame_bucket"]
    assert got.shape == want.shape and len(got) % ours.hop_length == 0
    assert rel_l2(got, want) <= WAV_REL_L2


def test_infer_z_only_and_phrases_match_jax(pair, jax_z):
    """Decoder-only on a whole z, and the phrase-level decode (one
    latents pass, each phrase's z decoded alone)."""
    ours, theirs = pair
    assert rel_l2(ours.infer_z_only(jax_z),
                  theirs.infer_z_only(jax_z)) <= WAV_REL_L2
    got = ours.synthesize_by_phrases(TEXT, noise_scale=0.0, seed=0)
    want = theirs.synthesize_by_phrases(TEXT, noise_scale=0.0, seed=0)
    assert [len(g) for g in got] == [len(w) for w in want]
    assert len(got) > 1
    assert rel_l2(np.concatenate(got), np.concatenate(want)) <= WAV_REL_L2
