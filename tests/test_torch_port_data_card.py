"""The data path and bf16 serving on a card: batches gathered by the
device-resident corpus on the card against the host batcher's moved to
the card (bit for bit, both feeds' keys, one and four speakers), the
host-spec batch through `device_prefetch`, and the bf16 serving module
against the f32 one on the same latents (correlation > 0.99) with f32
PCM on the int16 grid. Flagship config at the tiny width of
torch_port_data.py, random weights from a seed. Needs a CUDA device and
skips without one; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_data_card.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mb_istft_vits_torch.config import Config
from mb_istft_vits_torch.data import (
    BucketedBatcher,
    DeviceResidentFeeder,
    TextAudioDataset,
    device_prefetch,
    prefetch_epoch,
)
from mb_istft_vits_torch.infer.synthesis import SynthesisModule
from torch_port_data import write_tiny_config, write_tiny_dataset

TEXTS = ["ðə kwˈɪk bɹˈaʊn fˈɑːks, dʒˈʌmps ˌoʊvɚ ðə lˈeɪzi dˈɑːɡ.",
         "həlˈoʊ wˈɜːld."]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("multi_speaker", [False, True])
def test_resident_gathers_on_the_card_equal_host_batches(card, tmp_path,
                                                         multi_speaker):
    cfg = Config.from_json(write_tiny_dataset(str(tmp_path), n=8,
                                              multi_speaker=multi_speaker))
    batcher = BucketedBatcher(TextAudioDataset(cfg.data.training_files,
                                               cfg.data, device_spec=True), 2)
    feeder = DeviceResidentFeeder(batcher, device=card)
    assert feeder.nbytes == DeviceResidentFeeder.corpus_bytes(batcher)
    for epoch in (0, 1):
        for got, want in zip(feeder.iter_epoch(epoch),
                             batcher.iter_epoch(epoch)):
            assert sorted(got) == sorted(want)
            assert ("sid" in got) == multi_speaker
            for k, v in want.items():
                assert got[k].device.type == "cuda"
                assert torch.equal(got[k], torch.from_numpy(v).to(card)), k


@pytest.mark.cuda
def test_host_spec_batches_reach_the_card(card, tmp_path):
    cfg = Config.from_json(write_tiny_dataset(str(tmp_path), n=8))
    batcher = BucketedBatcher(TextAudioDataset(cfg.data.training_files,
                                               cfg.data), 2)
    want = list(batcher.iter_epoch(0))
    got = list(device_prefetch(prefetch_epoch(batcher, 0, 4), device=card))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert "spec" in g and g["spec"].device.type == "cuda"
        for k, v in w.items():
            assert torch.equal(g[k].cpu(), torch.from_numpy(v)), k


@pytest.mark.cuda
def test_bf16_serving_against_f32_on_the_card(card, tmp_path):
    path = write_tiny_config(str(tmp_path))
    low = SynthesisModule(path, None, None, 0, torch.bfloat16, device=card)
    full = SynthesisModule(path, None, None, 0, device=card)
    for text in TEXTS:
        z, y_len, _ = full.prepare_shared_latents(text, noise_scale=0.0,
                                                  seed=0)
        a, b = low.infer_z_only(z), full.infer_z_only(z)
        assert a.size == b.size == y_len * 256
        assert float(np.corrcoef(a, b)[0, 1]) > 0.99
        audio, _ = low.synthesize(text, noise_scale=0.0, seed=0)
        pcm = audio * 32767.0
        assert audio.dtype == np.float32 and np.isfinite(audio).all()
        np.testing.assert_array_equal(pcm, np.round(pcm))
