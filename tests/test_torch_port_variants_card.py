"""The multi-stream multi-speaker model on a card against the same model on
the CPU (which test_torch_port_variants*.py hold against the JAX
package): one training step with speaker ids, a seeded request repeated
bit for bit at one bucket, and voice conversion. Tiny width
(torch_port_data.py), random weights from a seed, TF32 off. Needs a CUDA
device and skips without one; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_variants_card.py
"""

from __future__ import annotations

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
from mb_istft_vits_torch.voice_conversion import convert
from torch_port_data import MS_CONFIG, write_tiny_config

TINY_MS = dict(n_vocab=59, spec_channels=513, segment_size=8,
               inter_channels=16, hidden_channels=16, filter_channels=32,
               n_heads=2, n_layers=1, kernel_size=3, p_dropout=0.0,
               resblock="1", resblock_kernel_sizes=(3,),
               resblock_dilation_sizes=((1, 3, 5),), upsample_rates=(4, 4),
               upsample_initial_channel=32, upsample_kernel_sizes=(16, 16),
               gen_istft_n_fft=16, gen_istft_hop_size=4, ms_istft_vits=True,
               n_speakers=3, gin_channels=8)
TEXT = "k o N n i t i w a sp s e k a i"
WAV_REL_L2 = 1e-3


def rel_l2(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(ours - ref) / max(np.linalg.norm(ref), 1e-12))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    disable_tf32()
    return torch.device("cuda")


def _batch_and_draws(cfg, seed=0, b=2, t_x=11, t_spec=40):
    rng = np.random.RandomState(seed)
    lw = np.array([t_spec * 256 + 100, (t_spec - 8) * 256 + 50])
    wav = np.zeros((b, t_spec * 256 + 768, 1), np.int16)
    for i in range(b):
        tone = np.sin(2 * np.pi * rng.uniform(90, 250) * np.arange(lw[i])
                      / 22050)
        wav[i, :lw[i], 0] = 3000 * tone + 1000 * rng.randn(lw[i])
    spec_lengths = np.minimum(lw // 256, t_spec).astype(np.int32)
    batch = {"x": rng.randint(1, 59, size=(b, t_x)).astype(np.int32),
             "x_lengths": np.array([t_x, t_x - 3], np.int32),
             "spec_lengths": spec_lengths, "wav": wav,
             "wav_lengths": lw.astype(np.int32),
             "sid": np.array([2, 0], np.int32)}
    eps = rng.randn(b, t_spec, cfg.model.inter_channels).astype(np.float32)
    ids = (rng.rand(b) * (spec_lengths - cfg.model.segment_size + 1)
           ).astype(np.int32)
    return ({k: torch.from_numpy(v) for k, v in batch.items()},
            tstep.StepDraws(torch.from_numpy(eps), torch.from_numpy(ids)))


@pytest.mark.cuda
def test_ms_speaker_train_step_on_the_card_matches_the_cpu(cuda_device):
    """Every dropout off (the duration predictor's too), lr 10 and eps 10:
    the losses within 1e-4 relative and every weight within 2e-4."""
    train = dict(learning_rate=10.0, eps=10.0, segment_size=2048,
                 batch_size=2)
    cfg = Config(ModelConfig(**TINY_MS), DataConfig(), TrainConfig(**train))
    batch, draws = _batch_and_draws(cfg)
    states, metrics = [], []
    for device in (torch.device("cpu"), cuda_device):
        state = tstep.create_train_state(cfg, device, seed=0)
        state.net_g.dp.drop.p = 0.0
        moved = tstep.StepDraws(*(None if v is None else v.to(device)
                                  for v in draws))
        m = tstep.train_step(state, {k: v.to(device)
                                     for k, v in batch.items()}, moved)
        states.append(state)
        metrics.append({k: float(v) for k, v in m.items()})
    cpu, card = metrics
    assert card["loss/g/subband"] == cpu["loss/g/subband"] == 0.0
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
    grad = states[1].net_g.emb_g.weight.grad
    assert [i for i in range(3) if grad[i].abs().sum() > 0] == [0, 2]


@pytest.fixture(scope="module")
def modules(tmp_path_factory):
    """{"cpu": module, "cuda": module} on the Japanese multi-speaker config
    shrunk, equal weights (the same seed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = write_tiny_config(str(tmp_path_factory.mktemp("cfg")), MS_CONFIG)
    out = {}
    for dev in ("cpu", "cuda"):
        m = SynthesisModule(path, seed=0, device=dev)
        m.TEXT_BUCKETS = (32, 64)
        m.FRAME_BUCKETS = (64, 128, 256)
        out[dev] = m
    return out


@pytest.mark.cuda
def test_ms_request_on_the_card_is_bit_reproducible(modules):
    m = modules["cuda"]
    runs = []
    for _ in range(2):
        m._frames_per_token, m._ratio_observed = 3.0, False
        runs.append(m.synthesize(TEXT, 5, seed=3))
    (a1, t1), (a2, t2) = runs
    assert t1["frame_bucket"] == t2["frame_bucket"]
    np.testing.assert_array_equal(a1, a2)
    m._frames_per_token, m._ratio_observed = 3.0, False
    cpu = modules["cpu"]
    cpu._frames_per_token, cpu._ratio_observed = 3.0, False
    got, _ = m.synthesize(TEXT, 5, noise_scale=0.0)
    want, _ = cpu.synthesize(TEXT, 5, noise_scale=0.0)
    assert got.shape == want.shape and rel_l2(got, want) <= WAV_REL_L2


@pytest.mark.cuda
def test_voice_conversion_on_the_card(modules):
    """The model's voice_conversion on one posterior draw matches the CPU;
    the CLI's `convert` keeps the length and changes the audio."""
    cpu, card = modules["cpu"], modules["cuda"]
    cpu._frames_per_token, cpu._ratio_observed = 3.0, False
    audio, _ = cpu.synthesize(TEXT, 0, seed=1)
    y = torch.from_numpy(np.random.RandomState(2).rand(1, 30, 513)
                         .astype(np.float32))
    eps = torch.from_numpy(np.random.RandomState(3).randn(1, 30, 16)
                           .astype(np.float32))
    outs = []
    for m in (card, cpu):
        d = m.device
        with torch.no_grad():
            o, *_ = m.model.voice_conversion(
                y.to(d), torch.tensor([30], device=d),
                torch.tensor([0], device=d), torch.tensor([5], device=d),
                posterior_eps=eps.to(d))
        outs.append(o.cpu().numpy())
    assert rel_l2(*outs) <= WAV_REL_L2
    converted = convert(card, audio, 0, 5)
    assert converted.shape == audio.shape and np.isfinite(converted).all()
    assert rel_l2(converted, audio) > 1e-2
