"""The serving layer on a card against the same module on the CPU (which
test_torch_port_serve.py holds against the JAX package): bucketed
`synthesize(noise_scale=0)`, the batch with resampling on the device, and
the chunked decodes of one latent, within 1e-3 relative L2 at equal
frame buckets and lengths. Flagship config at the tiny width of
torch_port_data.py, random weights from a seed, TF32 off. Needs a
CUDA device and skips without one; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_serve_card.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mb_istft_vits_torch.infer.synthesis import SynthesisModule
from torch_port_data import write_tiny_config

TEXT = "ðə kwˈɪk bɹˈaʊn fˈɑːks, dʒˈʌmps ˌoʊvɚ ðə lˈeɪzi dˈɑːɡ."
TEXTS = [TEXT, "həlˈoʊ wˈɜːld.", "ðə kwˈɪk bɹˈaʊn."]
WAV_REL_L2 = 1e-3


def rel_l2(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(ours - ref) / max(np.linalg.norm(ref), 1e-12))


@pytest.fixture(scope="module")
def modules(tmp_path_factory):
    """{"cpu": module, "cuda": module}, equal weights (the same seed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = write_tiny_config(str(tmp_path_factory.mktemp("cfg")))
    out = {}
    for dev in ("cpu", "cuda"):
        m = SynthesisModule(path, seed=0, device=dev)
        m.TEXT_BUCKETS = (32, 64)
        m.FRAME_BUCKETS = (64, 128, 256)
        out[dev] = m
    return out


def _run(m, path, z):
    if path == "synthesize":
        m._frames_per_token, m._ratio_observed = 3.0, False
        audio, t = m.synthesize(TEXT, noise_scale=0.0, seed=0)
        return [audio], t["frame_bucket"]
    if path == "synthesize_batch_16k":
        audios, _ = m.synthesize_batch(TEXTS, noise_scale=0.0,
                                       out_sample_rate=16000)
        return audios, None
    kw = dict(chunk_frames=16, overlap_frames=4)
    if path == "stream_from_latents":
        return [np.concatenate(list(m.stream_from_latents(z, **kw)))], None
    if path == "decode_spec_join_batched":
        return [m.decode_spec_join(z, batched=True, **kw)], None
    return [getattr(m, path)(z, **kw)], None


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["synthesize", "synthesize_batch_16k",
                                  "decode_spec_join",
                                  "decode_spec_join_batched",
                                  "stream_from_latents",
                                  "decode_chunks_batched"])
def test_serving_on_the_card_matches_the_cpu(modules, path):
    z, _, _ = modules["cpu"].prepare_shared_latents(TEXT, noise_scale=0.0)
    (got, bucket_g), (want, bucket_w) = (_run(modules[d], path, z)
                                         for d in ("cuda", "cpu"))
    assert bucket_g == bucket_w
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.size > 0
        assert np.all(np.isfinite(g))
        assert rel_l2(g, w) <= WAV_REL_L2, (path, rel_l2(g, w))


@pytest.mark.cuda
def test_serving_on_the_card_is_bit_reproducible(modules):
    """cuDNN's deterministic algorithms: a batch and a seeded request give
    the same PCM call after call."""
    m = modules["cuda"]
    first, _ = m.synthesize_batch(TEXTS, seed=7)
    again, _ = m.synthesize_batch(TEXTS, seed=7)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    m._frames_per_token, m._ratio_observed = 3.0, False
    a1, t1 = m.synthesize(TEXT, seed=3)
    m._frames_per_token, m._ratio_observed = 3.0, False
    a2, t2 = m.synthesize(TEXT, seed=3)
    assert t1["frame_bucket"] == t2["frame_bucket"]
    np.testing.assert_array_equal(a1, a2)
