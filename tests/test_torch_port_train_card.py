"""One training step on a card against the same step on the CPU.

The CPU step is held against the JAX package (test_torch_port_train.py);
this one holds the card's path to it: the MAS kernel, cuFFT for the
odd-size MR-STFT transforms, cuDNN with TF32 off. Tiny model (no dropout
outside the duration predictor), batch 2, a 2048-sample segment; lr 10
and eps 10 so the updated weights hold the gradients (see
test_torch_port_train.py). Needs a CUDA device and skips without one;
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_train_card.py
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
from mb_istft_vits_torch.train import step as tstep

TINY = dict(n_vocab=40, spec_channels=513, segment_size=8, inter_channels=16,
            hidden_channels=16, filter_channels=32, n_heads=2, n_layers=1,
            kernel_size=3, p_dropout=0.0, resblock="1",
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
            upsample_rates=(4, 4), upsample_initial_channel=32,
            upsample_kernel_sizes=(16, 16), gen_istft_n_fft=16,
            gen_istft_hop_size=4, mb_istft_vits=True)


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
    batch = {"x": rng.randint(1, 40, size=(b, t_x)).astype(np.int32),
             "x_lengths": np.array([t_x, t_x - 3], np.int32),
             "spec_lengths": spec_lengths, "wav": wav,
             "wav_lengths": lw.astype(np.int32)}
    eps = rng.randn(b, t_spec, cfg.model.inter_channels).astype(np.float32)
    ids = (rng.rand(b) * (spec_lengths - cfg.model.segment_size + 1)
           ).astype(np.int32)
    return ({k: torch.from_numpy(v) for k, v in batch.items()},
            tstep.StepDraws(torch.from_numpy(eps), torch.from_numpy(ids)))


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    train = dict(learning_rate=10.0, eps=10.0, segment_size=2048,
                 batch_size=2)
    cfg = Config(ModelConfig(**TINY), DataConfig(), TrainConfig(**train))
    batch, draws = _batch_and_draws(cfg)
    states, metrics = [], []
    for device in (torch.device("cpu"), cuda_device):
        state = tstep.create_train_state(cfg, device, seed=0)
        moved = tstep.StepDraws(*(None if v is None else v.to(device)
                                  for v in draws))
        m = tstep.train_step(state, {k: v.to(device)
                                     for k, v in batch.items()}, moved)
        states.append(state)
        metrics.append({k: float(v) for k, v in m.items()})
    cpu, card = metrics
    for k in ("loss/d/total", "grad_norm_d", "loss/g/gen", "loss/g/fm",
              "loss/g/mel", "loss/g/kl", "loss/g/subband"):
        assert abs(card[k] - cpu[k]) <= 1e-4 * abs(cpu[k]), (k, card[k],
                                                            cpu[k])
    assert all(np.isfinite(v) for v in card.values())
    for net in ("net_d", "net_g"):
        ref = getattr(states[0], net).state_dict()
        for k, v in getattr(states[1], net).state_dict().items():
            if k.startswith("dp."):  # its dropout draws differ
                continue
            err = float((v.cpu() - ref[k]).abs().max())
            assert err <= 2e-4, (k, err)
