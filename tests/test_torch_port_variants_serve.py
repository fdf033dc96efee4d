"""Serving parity of the PyTorch port's model variants with the JAX
package on the CPU: `SynthesisModule` of both on the single-band iSTFT
config (`ljs_istft_vits.json`) and the Japanese 12-speaker multi-stream
config (`uudb_ms_istft_vits_ms.json`), each shrunk to the tiny width of
torch_port_data.py (gin 8), loading one seeded reference-format `.pth`,
buckets shrunk to (32, 64) / (64, 128, 256): requests with a speaker,
batches of mixed speakers and the spectrogram-domain join, noise-free,
within 1e-3 relative L2 at equal frame buckets; and the JAX positional
order of `SynthesisModule.__init__`."""

from __future__ import annotations

import inspect
import json
import os

import numpy as np
import pytest
import torch

from mb_istft_vits_tpu.config import Config as JConfig
from mb_istft_vits_tpu.infer import synthesis as ref_serving

from mb_istft_vits_torch.config import Config
from mb_istft_vits_torch.infer import synthesis as port_serving

from torch_port_data import TINY_MODEL
from tests.torch_port_common import WAV_REL_L2, make_weights, rel_l2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_synthesis_module_takes_jax_positional_order(tmp_path):
    """(config_path, checkpoint_path, params, seed) as in JAX; `device`
    keyword-only; `params` is a state dict with the reference names."""
    names = list(inspect.signature(port_serving.SynthesisModule.__init__)
                 .parameters)
    assert names[1:5] == list(inspect.signature(
        ref_serving.SynthesisModule.__init__).parameters)[1:5]
    assert inspect.signature(port_serving.SynthesisModule.__init__) \
        .parameters["device"].kind is inspect.Parameter.KEYWORD_ONLY
    path = _tiny_json(tmp_path, "ljs_istft_vits.json")
    a = port_serving.SynthesisModule(path, None, None, 3, device="cpu")
    b = port_serving.SynthesisModule(path, seed=3, device="cpu")
    c = port_serving.SynthesisModule(path, None, b.model.state_dict(), 4,
                                     device="cpu")
    d = port_serving.SynthesisModule(path, None, None, 4, device="cpu")
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
        assert torch.equal(v, c.model.state_dict()[k]), k
    assert not all(torch.equal(v, d.model.state_dict()[k])
                   for k, v in a.model.state_dict().items())
    with pytest.raises(TypeError):
        port_serving.SynthesisModule(path, None, None, 3, "cpu")


def _tiny_json(root, name, **model):
    """configs/NAME with its model block shrunk to the tiny width."""
    with open(os.path.join(REPO, "configs", name)) as f:
        cfg = json.load(f)
    cfg["model"].update(TINY_MODEL, **model)
    path = os.path.join(str(root), "tiny_" + name)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


SERVE_CONFIGS = {"ljs_istft_vits.json": {},
                 "uudb_ms_istft_vits_ms.json": {"gin_channels": 8}}
JP_TEXTS = ["k o N n i t i w a sp s e k a i", "a r i g a t o: g o z a i m a s u",
            "s u m i m a s e N"]


def _shrink(m):
    m.TEXT_BUCKETS = (32, 64)
    m.FRAME_BUCKETS = (64, 128, 256)
    return m


@pytest.fixture(scope="module", params=sorted(SERVE_CONFIGS))
def serve_pair(request, tmp_path_factory):
    """(port module, JAX module, texts, sid) on one tiny config and .pth."""
    d = tmp_path_factory.mktemp("serve")
    path = _tiny_json(d, request.param, **SERVE_CONFIGS[request.param])
    make_weights(d, Config.from_json(path).model,
                 JConfig.from_json(path).model)
    pth = str(d / "G_0.pth")
    ours = _shrink(port_serving.SynthesisModule(path, pth, device="cpu"))
    theirs = _shrink(ref_serving.SynthesisModule(path, checkpoint_path=pth))
    multi = ours.cfg.n_speakers > 1
    texts = JP_TEXTS if multi else ["həlˈoʊ wˈɜːld.", "ðə kwˈɪk bɹˈaʊn.",
                                    "ɪts ɐ tˈɛst."]
    return ours, theirs, texts, (5 if multi else None)


def test_synthesize_with_sid_matches_jax(serve_pair):
    ours, theirs, texts, sid = serve_pair
    outs = []
    for m in (ours, theirs):
        m._frames_per_token, m._ratio_observed = 3.0, False
        outs.append(m.synthesize(texts[0], sid, noise_scale=0.0, seed=0))
    (got, tg), (want, tw) = outs
    assert tg["frame_bucket"] == tw["frame_bucket"]
    assert got.shape == want.shape and len(got) > 0
    assert rel_l2(got, want) <= WAV_REL_L2
    if sid is not None:  # another speaker, another waveform
        other, _ = ours.synthesize(texts[0], 1, noise_scale=0.0, seed=0)
        assert other.shape != got.shape or rel_l2(other, got) > 1e-2


def test_synthesize_batch_with_sids_matches_jax(serve_pair):
    ours, theirs, texts, sid = serve_pair
    sids = None if sid is None else [5, None, 11]
    got, _ = ours.synthesize_batch(texts, sids, noise_scale=0.0)
    want, _ = theirs.synthesize_batch(texts, sids, noise_scale=0.0)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_l2(g, w) <= WAV_REL_L2


@pytest.mark.parametrize("batched", [False, True])
def test_decode_spec_join_matches_jax(serve_pair, batched):
    ours, theirs, texts, sid = serve_pair
    theirs._frames_per_token, theirs._ratio_observed = 3.0, False
    _, z, _ = theirs.synthesize_with_z(" sp ".join(texts) if sid else
                                       " ".join(texts), sid,
                                       noise_scale=0.0, seed=0)
    kw = dict(chunk_frames=16, overlap_frames=4, batched=batched)
    got = ours.decode_spec_join(z, sid, **kw)
    want = theirs.decode_spec_join(z, sid, **kw)
    assert got.shape == want.shape == (len(z) * ours.hop_length,)
    assert rel_l2(got, want) <= WAV_REL_L2
    whole = ours.infer_z_only(z, sid)
    assert np.corrcoef(got, whole)[0, 1] > 0.98
