"""The trainer's evaluation metrics and checkpoint bookkeeping in the
PyTorch port against the JAX package on the CPU: `utils.metrics` (MCD, the
DTW-aligned MCD, LSD within 1e-4 relative; YIN F0 and the F0 metrics
exact) on seeded waves, and `train.checkpoint`'s `prune` / `record_best` /
`best_step` keeping and pruning the same steps as JAX's
`prune_checkpoints` / `record_best_checkpoint` / `best_checkpoint_step`
(the port prunes G/D `.pth` pairs in the model dir, JAX step dirs under
ckpt/)."""

from __future__ import annotations

import os

import numpy as np
import pytest

from mb_istft_vits_tpu.train import checkpoint as jckpt
from mb_istft_vits_tpu.utils import metrics as jmetrics

from mb_istft_vits_torch.train import checkpoint as ckpt
from mb_istft_vits_torch.utils import metrics

REL = 1e-4
SR = 16000
STFT = dict(n_fft=512, hop_length=128, win_length=512)


def _wave(seed, seconds=0.6, f0=140.0):
    """A harmonic tone with a pitch glide, in noise, after 0.25 s of
    silence (so the silence gates and voicing decisions have work to do)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.2 * t)) / SR
    x = sum(np.sin(k * phase + rng.uniform(0, 6)) / k for k in range(1, 6))
    x = 0.3 * x + 0.01 * rng.randn(t.size)
    x[:SR // 4] = 0.0
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def waves():
    ref = _wave(0)
    near = (ref + 0.02 * np.random.RandomState(1).randn(ref.size)).astype(
        np.float32)
    other = _wave(2, seconds=0.75, f0=180.0)  # another length and pitch
    return ref, near, other


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("pair", ["near", "other"])
def test_mcd_lsd_and_dtw_mcd_match_jax(waves, pair):
    ref, near, other = waves
    syn = near if pair == "near" else other
    kw = dict(STFT, n_mels=40)
    ours = metrics.mel_cepstral_distortion(ref, syn, SR, **kw)
    assert ours > 0 and _rel(
        ours, jmetrics.mel_cepstral_distortion(ref, syn, SR, **kw)) <= REL
    ours = metrics.log_spectral_distance(ref, syn, SR, **STFT)
    assert ours > 0 and _rel(
        ours, jmetrics.log_spectral_distance(ref, syn, SR, **STFT)) <= REL
    got = metrics.mcd_dtw(ref, syn, SR, **kw)
    want = jmetrics.mcd_dtw(ref, syn, SR, **kw)
    assert sorted(got) == sorted(want)
    for k in ("frames_ref", "frames_syn", "path_len"):
        assert got[k] == want[k], k
    for k in ("mcd_dtw", "dur_ratio"):
        assert _rel(got[k], want[k]) <= REL, k
    np.testing.assert_allclose(
        metrics.mel_cepstra(ref, SR, **kw), jmetrics.mel_cepstra(ref, SR, **kw),
        rtol=REL, atol=REL)


def test_f0_metrics_equal_jax(waves):
    ref, near, other = waves
    f0, voiced = metrics.yin_f0(ref, SR)
    j_f0, j_voiced = jmetrics.yin_f0(ref, SR)
    np.testing.assert_array_equal(f0, j_f0)
    np.testing.assert_array_equal(voiced, j_voiced)
    assert voiced.any() and not voiced.all()
    for syn in (near, other):
        assert metrics.f0_metrics(ref, syn, SR) == \
            jmetrics.f0_metrics(ref, syn, SR)


STEPS = [100, 200, 300, 25000, 25100, 30000, 50000, 50100, 50200, 50300]


def _port_dir(root, steps):
    os.makedirs(root, exist_ok=True)
    for s in steps:
        for p in "GD":
            open(os.path.join(root, f"{p}_{s}.pth"), "w").close()
    return str(root)


def _jax_dir(root, steps):
    for s in steps:
        os.makedirs(os.path.join(root, "ckpt", str(s)))
    return str(root)


def _jax_steps(model_dir):
    return sorted(int(d) for d in os.listdir(os.path.join(model_dir, "ckpt"))
                  if d.isdigit())


@pytest.mark.parametrize("keep_last,keep_steps", [(3, ()), (3, (200,)),
                                                  (1, (300, 50100)),
                                                  (5, (25100,))])
def test_prune_keeps_and_prunes_the_steps_jax_does(tmp_path, keep_last,
                                                   keep_steps):
    ours = _port_dir(tmp_path / "port", STEPS)
    theirs = _jax_dir(tmp_path / "jax", STEPS)
    pruned = ckpt.prune(ours, keep_last=keep_last, keep_steps=keep_steps)
    assert pruned == jckpt.prune_checkpoints(theirs, keep_last=keep_last,
                                             keep_steps=keep_steps)
    assert pruned and ckpt.saved_steps(ours) == _jax_steps(theirs)
    assert 25000 in ckpt.saved_steps(ours) and 50000 in ckpt.saved_steps(ours)
    # every pair goes whole: no G or D file of a pruned step is left
    left = sorted(os.listdir(ours))
    assert left == sorted(f"{p}_{s}.pth" for s in ckpt.saved_steps(ours)
                          for p in "GD")


def test_best_step_follows_its_pair_as_jax_does(tmp_path):
    ours = _port_dir(tmp_path / "port", STEPS[:3])
    theirs = _jax_dir(tmp_path / "jax", STEPS[:3])
    assert ckpt.best_step(ours) is None and \
        jckpt.best_checkpoint_step(theirs) is None
    for step, value in ((100, 9.5), (200, 7.25)):
        ckpt.record_best(ours, step, "eval/mcd_copy_synthesis", value)
        jckpt.record_best_checkpoint(theirs, step, "eval/mcd_copy_synthesis",
                                     value)
    assert ckpt.best_step(ours) == jckpt.best_checkpoint_step(theirs) == {
        "step": 200, "metric": "eval/mcd_copy_synthesis", "value": 7.25}
    assert not os.path.exists(os.path.join(ours, "best.json.tmp"))
    # the best pair protected, then gone: best_step forgets it, as JAX does
    keep = (ckpt.best_step(ours)["step"],)
    assert ckpt.prune(ours, keep_last=1, keep_steps=keep) == \
        jckpt.prune_checkpoints(theirs, keep_last=1, keep_steps=keep) == [100]
    assert ckpt.prune(ours, keep_last=1) == \
        jckpt.prune_checkpoints(theirs, keep_last=1) == [200]
    assert ckpt.best_step(ours) is None and \
        jckpt.best_checkpoint_step(theirs) is None
