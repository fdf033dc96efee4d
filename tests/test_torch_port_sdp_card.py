"""A model with the stochastic duration predictor (`use_sdp`) on a card
against the same model on the CPU (which test_torch_port_sdp*.py hold
against the JAX package): one training step with the predictor's
posterior noise given, noise-free serving within 1e-3, and on the card a
seeded request at noise_scale_w 0.8 repeated bit for bit with the probe's
frames the decode's. Tiny width (torch_port_data.py), random weights from
a seed, TF32 off. Needs a CUDA device and skips without one; imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_sdp_card.py
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from mb_istft_vits_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from mb_istft_vits_torch.device import disable_tf32
from mb_istft_vits_torch.infer.synthesis import SynthesisModule
from mb_istft_vits_torch.train import step as tstep
from test_torch_port_variants_card import TINY_MS, _batch_and_draws, rel_l2
from torch_port_data import write_tiny_config

TEXT = "ðə kwˈɪk bɹˈaʊn fˈɑːks."
WAV_REL_L2 = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    disable_tf32()
    return torch.device("cuda")


@pytest.mark.cuda
def test_sdp_train_step_on_the_card_matches_the_cpu(cuda_device):
    """Every dropout off, lr 10 and eps 10, one posterior draw of the
    predictor for both: the losses within 1e-4 relative (loss/g/dur the
    flow NLL) and every weight within 2e-4."""
    train = dict(learning_rate=10.0, eps=10.0, segment_size=2048,
                 batch_size=2)
    cfg = Config(ModelConfig(**dict(TINY_MS, use_sdp=True)), DataConfig(),
                 TrainConfig(**train))
    batch, draws = _batch_and_draws(cfg)
    sdp_eps = torch.from_numpy(np.random.RandomState(7).randn(
        2, batch["x"].shape[1], 2).astype(np.float32))
    states, metrics = [], []
    for device in (torch.device("cpu"), cuda_device):
        state = tstep.create_train_state(cfg, device, seed=0)
        for dds in (state.net_g.dp.convs, state.net_g.dp.post_convs):
            dds.drop.p = 0.0
        moved = tstep.StepDraws(draws.posterior_eps.to(device),
                                draws.ids_slice.to(device),
                                sdp_eps.to(device))
        m = tstep.train_step(state, {k: v.to(device)
                                     for k, v in batch.items()}, moved)
        states.append(state)
        metrics.append({k: float(v) for k, v in m.items()})
    cpu, card = metrics
    for k in ("loss/d/total", "grad_norm_d", "loss/g/gen", "loss/g/fm",
              "loss/g/mel", "loss/g/kl", "loss/g/dur", "grad_norm_g"):
        assert abs(card[k] - cpu[k]) <= 1e-4 * abs(cpu[k]), (k, card[k],
                                                            cpu[k])
    assert all(np.isfinite(v) for v in card.values())
    for net in ("net_d", "net_g"):
        ref = getattr(states[0], net).state_dict()
        for k, v in getattr(states[1], net).state_dict().items():
            err = float((v.cpu() - ref[k]).abs().max())
            assert err <= 2e-4, (k, err)


@pytest.fixture(scope="module")
def modules(tmp_path_factory):
    """{"cpu": module, "cuda": module} on the flagship config shrunk, with
    the stochastic duration predictor, equal weights (the same seed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = write_tiny_config(str(tmp_path_factory.mktemp("cfg")))
    with open(path) as f:
        cfg = json.load(f)
    cfg["model"]["use_sdp"] = True
    with open(path, "w") as f:
        json.dump(cfg, f)
    disable_tf32()
    out = {}
    for dev in ("cpu", "cuda"):
        m = SynthesisModule(path, seed=0, device=dev)
        m.TEXT_BUCKETS = (32, 64)
        m.FRAME_BUCKETS = (64, 128, 256)
        out[dev] = m
    return out


def _fresh(m):
    m._frames_per_token, m._ratio_observed = 3.0, False
    return m


@pytest.mark.cuda
def test_sdp_noise_free_request_on_the_card_matches_the_cpu(modules):
    kw = dict(noise_scale=0.0, noise_scale_w=0.0)
    got, tg = _fresh(modules["cuda"]).synthesize(TEXT, **kw)
    want, tw = _fresh(modules["cpu"]).synthesize(TEXT, **kw)
    assert tg["frame_bucket"] == tw["frame_bucket"]
    assert got.shape == want.shape and rel_l2(got, want) <= WAV_REL_L2


@pytest.mark.cuda
def test_sdp_seeded_request_on_the_card_repeats_with_the_probes_frames(
        modules, monkeypatch):
    m = modules["cuda"]
    probes = []
    # the module's probe program (a graph replay: the model's own method
    # runs only while the graph is captured)
    predict = m._predict_frames

    def recording(*args, **kwargs):
        out = predict(*args, **kwargs)
        probes.append(int(out[0]))
        return out

    monkeypatch.setattr(m, "_predict_frames", recording)
    runs = [_fresh(m).synthesize(TEXT, noise_scale_w=0.8, seed=3)
            for _ in range(2)]
    (a1, t1), (a2, t2) = runs
    assert t1["frame_bucket"] == t2["frame_bucket"]
    np.testing.assert_array_equal(a1, a2)
    assert probes == [a1.size // m.hop_length] * 2
    other, _ = _fresh(m).synthesize(TEXT, noise_scale_w=0.0, seed=3)
    assert other.size != a1.size
