"""Serving a model with the stochastic duration predictor (`use_sdp`).

Against the JAX package's `SynthesisModule` on the CPU: the flagship
config shrunk to the tiny width of torch_port_data.py with `use_sdp`, one
seeded reference-format `.pth`, buckets shrunk to (32, 64) /
(64, 128, 256), noise-free (noise_scale 0, noise_scale_w 0): equal frames
and waveforms within 1e-3 relative L2, for requests and batches.

The port alone, with the predictor's noise on (noise_scale_w 0.8): on
every route the frame-bucket probe and the decode see the same draw, so
the probe's frames are the decode's; a seeded request repeats bit for
bit; noise_scale_w changes the frames on every route.
"""

from __future__ import annotations

import numpy as np
import pytest

from mb_istft_vits_tpu.config import Config as JConfig
from mb_istft_vits_tpu.infer import synthesis as ref_serving

from mb_istft_vits_torch.config import Config
from mb_istft_vits_torch.infer import synthesis as port_serving

from tests.test_torch_port_variants_serve import _shrink, _tiny_json
from tests.torch_port_common import WAV_REL_L2, make_weights, rel_l2

TEXTS = ["həlˈoʊ wˈɜːld.", "ðə kwˈɪk bɹˈaʊn fˈɑːks.", "ɪts ɐ tˈɛst."]


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    d = tmp_path_factory.mktemp("sdp_serve")
    path = _tiny_json(d, "ljs_mb_istft_vits.json", use_sdp=True)
    make_weights(d, Config.from_json(path).model,
                 JConfig.from_json(path).model)
    pth = str(d / "G_0.pth")
    ours = _shrink(port_serving.SynthesisModule(path, pth, device="cpu"))
    assert ours.cfg.use_sdp
    return ours, pth, path


def _fresh(m):
    """Forget the frames-per-token estimate: the next request's bucket
    comes from the duration probe."""
    m._frames_per_token, m._ratio_observed = 3.0, False
    return m


def test_noise_free_requests_and_batches_match_jax(serving):
    ours, pth, path = serving
    theirs = _shrink(ref_serving.SynthesisModule(path, checkpoint_path=pth))
    kw = dict(noise_scale=0.0, noise_scale_w=0.0)
    for text in TEXTS[:2]:
        got, tg = _fresh(ours).synthesize(text, seed=0, **kw)
        want, tw = _fresh(theirs).synthesize(text, seed=0, **kw)
        assert tg["frame_bucket"] == tw["frame_bucket"]
        assert got.shape == want.shape and len(got) > 0
        assert rel_l2(got, want) <= WAV_REL_L2
    got, _ = ours.synthesize_batch(TEXTS, **kw)
    want, _ = theirs.synthesize_batch(TEXTS, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_l2(g, w) <= WAV_REL_L2


class _Recorder:
    """Wraps the model's predict_frames and infer / infer_z_only, recording
    the probe's frames and the decode's y_lengths, each with its w_eps."""

    def __init__(self, model, monkeypatch):
        self.probes, self.decodes = [], []
        for name, log, field in (("predict_frames", self.probes, None),
                                 ("infer", self.decodes, "y_lengths"),
                                 ("infer_z_only", self.decodes, 2)):
            monkeypatch.setattr(model, name,
                                self._wrap(getattr(model, name), log, field))

    @staticmethod
    def _wrap(fn, log, field):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            frames = out if field is None else (
                getattr(out, field) if isinstance(field, str) else out[field])
            log.append((kwargs["w_eps"].clone(), frames.clone()))
            return out
        return call


ROUTES = {
    "synthesize": lambda m, nsw, seed: m.synthesize(
        TEXTS[1], noise_scale_w=nsw, seed=seed),
    "synthesize_unseeded": lambda m, nsw, seed: m.synthesize(
        TEXTS[1], noise_scale_w=nsw),
    "prepare_shared_latents": lambda m, nsw, seed: m.prepare_shared_latents(
        TEXTS[1], noise_scale_w=nsw, seed=seed),
    "synthesize_batch": lambda m, nsw, seed: m.synthesize_batch(
        TEXTS, noise_scale_w=nsw, seed=seed),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_probe_and_decode_take_one_draw(serving, route, monkeypatch):
    """noise_scale_w 0.8: the probe's frames are the decode's, row by row,
    under one w_eps."""
    ours = serving[0]
    rec = _Recorder(ours.model, monkeypatch)
    for seed in range(3):
        _fresh(ours)
        ROUTES[route](ours, 0.8, seed)
    assert len(rec.probes) == 3 and len(rec.decodes) >= 3
    for (w_probe, frames), (w_decode, y_lengths) in zip(rec.probes,
                                                        rec.decodes):
        assert w_probe.shape[-1] == 2
        np.testing.assert_array_equal(w_probe.numpy(), w_decode.numpy())
        np.testing.assert_array_equal(frames.numpy(), y_lengths.numpy())


def test_seeded_request_repeats_bit_for_bit(serving):
    ours = serving[0]
    a, ta = _fresh(ours).synthesize(TEXTS[0], noise_scale_w=0.8, seed=5)
    b, tb = _fresh(ours).synthesize(TEXTS[0], noise_scale_w=0.8, seed=5)
    assert ta["frame_bucket"] == tb["frame_bucket"]
    np.testing.assert_array_equal(a, b)
    c, _ = _fresh(ours).synthesize(TEXTS[0], noise_scale_w=0.8, seed=6)
    assert c.shape != a.shape or not np.array_equal(a, c)


def _frames(route, m, nsw):
    out = ROUTES[route](m, nsw, 1)
    hop = m.hop_length
    if route == "prepare_shared_latents":
        return [out[1]]
    if route == "synthesize_batch":
        return [len(a) // hop for a in out[0]]
    return [len(out[0]) // hop]


@pytest.mark.parametrize("route", ["synthesize", "prepare_shared_latents",
                                   "synthesize_batch", "long_text"])
def test_noise_scale_w_moves_the_frames(serving, route, monkeypatch):
    """The same text and seed at noise_scale_w 0 and 0.8 give other frame
    counts on each route (the long-text split's pieces included)."""
    ours = serving[0]
    if route == "long_text":
        monkeypatch.setattr(ours, "MAX_TEXT_TOKENS", 12)
        text = " ".join(TEXTS)
        runs = [_fresh(ours).synthesize(text, noise_scale_w=nsw, seed=1)
                for nsw in (0.0, 0.8)]
        assert runs[0][1]["pieces"] > 1
        frames = [len(a) // ours.hop_length for a, _ in runs]
    else:
        frames = [_frames(route, _fresh(ours), nsw) for nsw in (0.0, 0.8)]
    assert frames[0] != frames[1], frames
