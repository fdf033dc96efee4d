"""Trainer parity of the PyTorch port with the JAX package on the CPU: the
STFT / spectrogram / mel front ends, PQMF analysis, every loss, the
weight-normed Conv2d, the multi-period discriminator and its weight
bridge and its G step's pass (the real half outside autograd),
`Synthesizer.fake_slice`, AdamW and the lr schedule, the
dataset and bucketed batcher, and one whole D + G step against
`make_train_step`'s `d_step` and `g_step`, on each feed: int16 PCM with
the spectrogram computed in the step, and host spectrograms.

Tiny model of torch_port_common with p_dropout 0, hop 256 (513 bins),
a 2048-sample segment, batch 2. Tolerances: f32 max-abs <= 1e-4 for
tensors, relative <= 1e-4 for loss scalars, <= 1e-6 relative for the
optimizer; exceptions are stated where they are made.
"""

from __future__ import annotations

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from mb_istft_vits_tpu import losses as jlosses
from mb_istft_vits_tpu.config import Config as JConfig
from mb_istft_vits_tpu.config import DataConfig as JDataConfig
from mb_istft_vits_tpu.config import TrainConfig as JTrainConfig
from mb_istft_vits_tpu.data.dataset import BucketedBatcher as JBatcher
from mb_istft_vits_tpu.data.dataset import TextAudioDataset as JDataset
from mb_istft_vits_tpu.dsp.mel import mel_filterbank as j_mel_filterbank
from mb_istft_vits_tpu.dsp.mel import mel_spectrogram as j_mel_spectrogram
from mb_istft_vits_tpu.dsp.mel import spec_to_mel as j_spec_to_mel
from mb_istft_vits_tpu.dsp.pqmf import PQMFBank
from mb_istft_vits_tpu.dsp.stft import spectrogram as j_spectrogram
from mb_istft_vits_tpu.dsp.stft import stft_magnitude as j_stft_magnitude
from mb_istft_vits_tpu.models import MultiPeriodDiscriminator as JMPD
from mb_istft_vits_tpu.models import Synthesizer as JSynthesizer
from mb_istft_vits_tpu.nn.layers import Conv2dP
from mb_istft_vits_tpu.ops import rand_slice_segments as j_rand_slice
from mb_istft_vits_tpu.train.checkpoint import import_torch_discriminator
from mb_istft_vits_tpu.train.step import (
    TrainState as JTrainState,
    leaf_adamw,
    make_optimizers,
    make_train_step,
)
from mb_istft_vits_tpu.train.step import make_lr_schedule as j_lr_schedule

from mb_istft_vits_torch import losses
from mb_istft_vits_torch.config import Config, DataConfig, TrainConfig
from mb_istft_vits_torch.data import BucketedBatcher, TextAudioDataset
from mb_istft_vits_torch.data.dataset import _spectrogram_host
from mb_istft_vits_torch.dsp import mel, spectrogram, stft_magnitude
from mb_istft_vits_torch.dsp.pqmf import PQMF
from mb_istft_vits_torch.models import MultiPeriodDiscriminator, synthesizer
from mb_istft_vits_torch.nn import Conv2d
from mb_istft_vits_torch.train import step as tstep
from mb_istft_vits_torch.weights import (
    discriminator_state_dict_from_jax,
    state_dict_from_jax,
)

from tests.torch_port_common import (
    assert_close,
    configs,
    japply,
    make_weights,
    n,
    t,
)

REL = 1e-4
SEG = 2048  # samples: 8 frames at hop 256
MRSTFT = dict(fft_sizes=(384, 683, 171), hop_sizes=(30, 60, 10),
              win_lengths=(150, 300, 60))  # the flagship's
# G leaves of the whole-step test (see test_train_step_matches_make_train_step)
MRSTFT_LEAVES = "dec.subband_conv_post."
ZERO_GRAD_G = {"enc_p.encoder.attn_layers.0.conv_k.bias"}


def jcall(fn, *arrays, **static):
    """A JAX function under jit (one compile instead of one per op), its
    keyword arguments static; results as numpy."""
    out = jax.jit(functools.partial(fn, **static))(*arrays)
    return jax.tree.map(np.asarray, out)


def rel_err(ours, ref) -> float:
    ours, ref = float(ours), float(ref)
    return abs(ours - ref) / max(abs(ref), 1e-12)


def _wave(rng, *shape, amp=0.3):
    """Harmonic tone plus noise, like speech in level and spectrum."""
    t_ = np.arange(shape[-1]) / 22050.0
    f0 = rng.uniform(90, 250, shape[:-1] + (1,))
    tone = sum(np.sin(2 * np.pi * k * f0 * t_ + rng.uniform(0, 6))
               / k for k in range(1, 6))
    return (amp * 0.4 * tone + amp * 0.3 * rng.randn(*shape)).astype(
        np.float32)


def _d_from_port(net_d, tmp_path):
    """port D -> reference D_*.pth -> the JAX package's importer (the
    187 MB file goes once read)."""
    path = str(tmp_path / "D_0.pth")
    torch.save({"model": net_d.state_dict(), "iteration": 0,
                "learning_rate": 2e-4, "optimizer": None}, path)
    try:
        return import_torch_discriminator(path)
    finally:
        os.remove(path)


# -- dsp --------------------------------------------------------------------


@pytest.mark.parametrize("n_fft,hop,win", [(384, 30, 150), (683, 60, 300),
                                           (171, 10, 60)])
def test_stft_magnitude_matches_jax(n_fft, hop, win):
    y = _wave(np.random.RandomState(0), 3, SEG // 4)
    ours = stft_magnitude(t(y), n_fft, hop, win, eps=1e-7)
    ref = jcall(j_stft_magnitude, y, n_fft=n_fft, hop_length=hop,
                win_length=win, eps=1e-7)
    assert_close(n(ours), ref, what=f"stft_magnitude {n_fft}")


@pytest.mark.parametrize("n_fft,hop,win", [(1024, 256, 1024),
                                           (256, 64, 200)])
def test_spectrogram_matches_jax(n_fft, hop, win):
    y = _wave(np.random.RandomState(1), 2, 5000)
    ours = spectrogram(t(y), n_fft, hop, win)
    ref = jcall(j_spectrogram, y, n_fft=n_fft, hop_length=hop,
                win_length=win)
    assert_close(n(ours), ref, what="spectrogram")


def test_mel_matches_jax():
    y = _wave(np.random.RandomState(2), 2, 6000)
    np.testing.assert_array_equal(
        mel.mel_filterbank(22050, 1024, 80, 0.0, None),
        j_mel_filterbank(22050, 1024, 80, 0.0, None))
    kw = dict(n_fft=1024, num_mels=80, sampling_rate=22050, fmin=0.0,
              fmax=None)
    spec = jcall(j_spectrogram, y, n_fft=1024, hop_length=256,
                 win_length=1024)
    ours = mel.spec_to_mel(t(spec), **kw)
    assert_close(n(ours), jcall(j_spec_to_mel, spec, **kw),
                 what="spec_to_mel")
    ours = mel.mel_spectrogram(t(y), hop_size=256, win_size=1024, **kw)
    ref = jcall(j_mel_spectrogram, y, hop_size=256, win_size=1024, **kw)
    assert_close(n(ours), ref, what="mel_spectrogram")


@pytest.mark.parametrize("length", [SEG, SEG + 3])
def test_pqmf_analysis_matches_jax(length):
    y = _wave(np.random.RandomState(3), 2, length)
    ours = PQMF(4).analysis_bm(t(y)[:, None])
    ref = jcall(PQMFBank(4).analysis_bm, y[..., None])
    assert ours.shape == (2, 4, -(-length // 4))
    assert_close(n(ours), ref, what="analysis_bm")


# -- losses -----------------------------------------------------------------


def test_gan_and_kl_losses_match_jax():
    rng = np.random.RandomState(4)
    outs_r = [rng.randn(2, k).astype(np.float32) for k in (5, 9, 3)]
    outs_g = [rng.randn(2, k).astype(np.float32) for k in (5, 9, 3)]
    fmaps_r = [[rng.randn(2, 4, k).astype(np.float32) for k in (7, 3)]
               for _ in range(3)]
    fmaps_g = [[rng.randn(2, 4, k).astype(np.float32) for k in (7, 3)]
               for _ in range(3)]
    tt = lambda xs: [t(x) for x in xs]  # noqa: E731
    d_ours, r_ours, g_ours = losses.discriminator_loss(tt(outs_r),
                                                       tt(outs_g))
    d_ref, r_ref, g_ref = jcall(jlosses.discriminator_loss, outs_r, outs_g)
    for a, b in zip([d_ours, *r_ours, *g_ours], [d_ref, *r_ref, *g_ref]):
        assert rel_err(a, b) <= REL
    gen_ours, parts = losses.generator_loss(tt(outs_g))
    gen_ref, parts_ref = jcall(jlosses.generator_loss, outs_g)
    for a, b in zip([gen_ours, *parts], [gen_ref, *parts_ref]):
        assert rel_err(a, b) <= REL
    fm = losses.feature_loss([tt(f) for f in fmaps_r],
                             [tt(f) for f in fmaps_g])
    assert rel_err(fm, jcall(jlosses.feature_loss, fmaps_r, fmaps_g)) <= REL
    z_p, logs_q, m_p, logs_p = (rng.randn(2, 13, 6).astype(np.float32) * 0.5
                                for _ in range(4))
    mask = (np.arange(13)[None, :, None] < np.array([13, 9])[:, None, None]
            ).astype(np.float32)
    kl = losses.kl_loss(*(t(v) for v in (z_p, logs_q, m_p, logs_p, mask)))
    ref = jcall(jlosses.kl_loss, z_p, logs_q, m_p, logs_p, mask)
    assert rel_err(kl, ref) <= REL


def test_stft_losses_match_jax():
    rng = np.random.RandomState(5)
    x = _wave(rng, 3, SEG // 4)
    y = _wave(rng, 3, SEG // 4)
    for fs, hs, wl in zip(*MRSTFT.values()):
        ours = losses.stft_loss_pair(t(x), t(y), fs, hs, wl)
        ref = jcall(jlosses.stft_loss_pair, x, y, fft_size=fs, hop=hs,
                    win=wl)
        assert max(rel_err(a, b) for a, b in zip(ours, ref)) <= REL, fs
    ours = losses.multi_resolution_stft_loss(t(x), t(y), **MRSTFT)
    ref = jcall(jlosses.multi_resolution_stft_loss, x, y, **MRSTFT)
    assert max(rel_err(a, b) for a, b in zip(ours, ref)) <= REL
    y_mb = _wave(rng, 2, 4, SEG // 4)
    y_hat_mb = _wave(rng, 2, 4, SEG // 4 + 5)  # cut to the shorter length
    ours = losses.subband_stft_loss(t(y_mb), t(y_hat_mb), **MRSTFT)
    ref = jcall(jlosses.subband_stft_loss, y_mb, y_hat_mb, **MRSTFT)
    assert rel_err(ours, ref) <= REL


# -- discriminator ----------------------------------------------------------


def test_conv2d_matches_flax():
    torch.manual_seed(0)
    conv = Conv2d(3, 5, (5, 1), (3, 1), (2, 0), weight_norm=True)
    with torch.no_grad():
        conv.weight_g.mul_(1.7)  # g apart from ||v||
    x = np.random.RandomState(6).randn(2, 3, 17, 4).astype(np.float32)
    params = {"v": n(conv.weight_v).transpose(2, 3, 1, 0),
              "g": n(conv.weight_g).reshape(-1), "bias": n(conv.bias)}
    ref = japply(Conv2dP(5, (5, 1), (3, 1), (2, 0), weight_norm=True),
                 params, x.transpose(0, 2, 3, 1))
    assert_close(n(conv(t(x))).transpose(0, 2, 3, 1), ref)


@pytest.fixture(scope="module")
def disc(tmp_path_factory):
    """(seeded port D, the same weights as a JAX tree via the reference
    .pth and the JAX importer)."""
    torch.manual_seed(7)
    net_d = MultiPeriodDiscriminator()
    return net_d, _d_from_port(net_d, tmp_path_factory.mktemp("d"))


def test_discriminator_weight_bridge_round_trips(disc):
    net_d, params = disc
    sd = discriminator_state_dict_from_jax(params)
    ours = net_d.state_dict()
    assert sorted(sd) == sorted(ours)
    for k, v in ours.items():
        assert torch.equal(sd[k], v), k
    MultiPeriodDiscriminator().load_state_dict(sd)  # strict


def test_discriminator_matches_flax(disc):
    net_d, params = disc
    rng = np.random.RandomState(8)
    y, y_hat = _wave(rng, 2, SEG), _wave(rng, 2, SEG, amp=0.1)
    with torch.no_grad():
        ours = net_d(t(y)[:, None], t(y_hat)[:, None])
    ref = japply(JMPD(), params, y[..., None], y_hat[..., None])
    for o_scores, r_scores in zip(ours[:2], ref[:2]):
        for o, r in zip(o_scores, r_scores):
            assert_close(n(o), r, what="scores")
    for o_maps, r_maps in zip(ours[2:], ref[2:]):
        for o_disc, r_disc in zip(o_maps, r_maps):
            assert len(o_disc) == len(r_disc)
            for o, r in zip(o_disc, r_disc):
                # torch [B, C, T(, p)] against flax [B, T(, p), C]
                assert_close(np.moveaxis(n(o), 1, -1), r, what="fmap")


# -- the G step's discriminator pass ------------------------------------------


def joint_d_pass(net_d, y, y_hat):
    """Real and fake through each sub-discriminator as one batch of 2B,
    whatever needs a gradient: the formulation that the G step's split
    pass must reproduce."""
    b = y.shape[0]
    both = torch.cat([y, y_hat.to(y.dtype)])
    res = [], [], [], []
    for d in net_d.discriminators:
        score, fmap = d(both)
        for acc, v in zip(res, (score[:b], score[b:], [f[:b] for f in fmap],
                                [f[b:] for f in fmap])):
            acc.append(v)
    return res


@contextlib.contextmanager
def d_call_rows(net_d):
    """The rows of each sub-discriminator call inside the block, in order."""
    rows = []
    hooks = [d.register_forward_hook(
        lambda mod, args, out: rows.append(args[0].shape[0]))
        for d in net_d.discriminators]
    try:
        yield rows
    finally:
        for h in hooks:
            h.remove()


def _rel_l2(ours, ref) -> float:
    ours, ref = ours.detach().double(), ref.detach().double()
    return float(torch.linalg.vector_norm(ours - ref)
                 / max(float(torch.linalg.vector_norm(ref)), 1e-30))


def _flat(outs):
    """(scores, maps) of a D pass's result -> (real tensors, fake ones)."""
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = outs
    return ([*y_d_rs, *(f for m in fmap_rs for f in m)],
            [*y_d_gs, *(f for m in fmap_gs for f in m)])


def check_g_step_d_pass(state, batch, draws, seed=14):
    """The G step's D pass on `batch` (the collate's) and `draws`: with D
    frozen and the real slice needing no gradient, each sub-discriminator
    runs twice on B rows, the real half's scores and maps carry no
    autograd graph and the fake half's do, and both match the one 2B pass
    (D's parameters needing gradients) to 1e-6 relative L2; G's gradients
    after `g_backward` match those of the 2B formulation to 1e-6 relative
    L2, leaf by leaf, and so do its losses. `seed` fixes the duration
    predictor's dropout in both forwards."""
    net_d = state.net_d
    prepped = tstep.prep_batch(batch, state.cfg)

    def forward():
        torch.manual_seed(seed)
        out = tstep.g_forward(state, prepped, draws)
        return out, tstep.real_slice(state, prepped, out[4])

    out, y = forward()
    y_hat = out[0].transpose(1, 2)
    b = y.shape[0]
    assert not y.requires_grad and y_hat.requires_grad
    with d_call_rows(net_d) as rows:
        joint = net_d(y, y_hat)
    assert rows == [2 * b] * len(net_d.discriminators)
    net_d.requires_grad_(False)
    try:
        with d_call_rows(net_d) as rows:
            split = net_d(y, y_hat)
    finally:
        net_d.requires_grad_(True)
    assert rows == [b, b] * len(net_d.discriminators)
    (s_real, s_fake), (j_real, j_fake) = _flat(split), _flat(joint)
    assert len(s_real) == len(j_real) == len(s_fake) == len(j_fake)
    assert all(v.grad_fn is None for v in s_real)
    assert all(v.grad_fn is not None for v in s_fake)
    for ours, ref in zip(s_real + s_fake, j_real + j_fake):
        assert ours.shape == ref.shape
        assert _rel_l2(ours, ref) <= 1e-6

    losses = tstep.g_backward(state, prepped, out, y)
    grads = {k: p.grad.clone() for k, p in state.net_g.named_parameters()}
    out, y = forward()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(net_d, "forward", functools.partial(joint_d_pass, net_d))
        ref_losses = tstep.g_backward(state, prepped, out, y)
    for k, v in ref_losses.items():
        assert rel_err(losses[k], v) <= 1e-6, k
    moved = 0
    for k, p in state.net_g.named_parameters():
        if float(torch.linalg.vector_norm(p.grad)) == 0.0:
            assert not grads[k].any(), k
            continue
        assert _rel_l2(grads[k], p.grad) <= 1e-6, k
        moved += 1
    assert moved > 100


def check_d_step_d_pass(state, batch, draws):
    """The D step on `batch` (the collate's) and `draws` still runs each
    sub-discriminator once on 2B rows, and D's gradients and loss equal
    those of the 2B formulation bit for bit."""
    net_d = state.net_d
    prepped = tstep.prep_batch(batch, state.cfg)
    with torch.no_grad():
        out = tstep.g_forward(state, prepped, draws)
    y, y_hat = tstep.real_slice(state, prepped, out[4]), out[0].transpose(1, 2)
    with d_call_rows(net_d) as rows:
        loss = tstep.d_backward(state, y, y_hat)
    assert rows == [2 * y.shape[0]] * len(net_d.discriminators)
    grads = {k: p.grad.clone() for k, p in net_d.named_parameters()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(net_d, "forward", functools.partial(joint_d_pass, net_d))
        ref_loss = tstep.d_backward(state, y, y_hat)
    assert torch.equal(loss, ref_loss)
    for k, p in net_d.named_parameters():
        assert p.grad.any(), k
        assert torch.equal(grads[k], p.grad), k


@pytest.fixture(scope="module")
def d_pass_state(disc, tmp_path_factory):
    """A port train state of step_run's configs at SEG samples, its D the
    seeded `disc`, its G every leaf non-zero; a collate-shaped batch and
    the step's draws for it."""
    cfg_t, cfg_j = configs(p_dropout=0.0)
    _, model = make_weights(tmp_path_factory.mktemp("d_pass"), cfg_t, cfg_j)
    train = dict(segment_size=SEG, batch_size=2, steps_per_epoch=1)
    cfg = Config(model=cfg_t, data=DataConfig(), train=TrainConfig(**train))
    state = tstep.create_train_state(cfg, torch.device("cpu"), seed=0)
    state.net_g.load_state_dict(model.state_dict())
    state.net_d.load_state_dict(disc[0].state_dict())
    batch = {k: t(v) for k, v in _step_batch().items()}
    return state, batch, tstep.draw_step(state, batch)


def test_g_step_d_pass_leaves_the_real_half_out_of_autograd(d_pass_state):
    check_g_step_d_pass(*d_pass_state)


def test_d_step_d_pass_is_one_joint_batch(d_pass_state):
    check_d_step_d_pass(*d_pass_state)


def test_g_loss_backward_counts_one_real_d_forward_less(disc):
    """Under FlopCounterMode, the backward of a generator-style loss
    (`generator_loss` + `feature_loss`) through the frozen D counts
    exactly one D forward on the real rows less than the same loss through
    the 2B formulation: the real half's input gradients are not run."""
    from torch.utils.flop_counter import FlopCounterMode

    net_d = disc[0]
    rng = np.random.RandomState(9)
    y = t(_wave(rng, 2, 1, 1024))
    y_hat = t(_wave(rng, 2, 1, 1024, amp=0.1)).requires_grad_(True)

    def backward_flops(d_pass):
        _, y_d_g, fmap_r, fmap_g = d_pass(y, y_hat)
        loss = losses.generator_loss(y_d_g)[0] + losses.feature_loss(
            fmap_r, fmap_g)
        with FlopCounterMode(display=False) as counter:
            loss.backward()
        return counter.get_total_flops()

    net_d.requires_grad_(False)
    try:
        split = backward_flops(net_d)
        joint = backward_flops(functools.partial(joint_d_pass, net_d))
    finally:
        net_d.requires_grad_(True)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        for d in net_d.discriminators:
            d(y)
    real_forward = counter.get_total_flops()
    assert real_forward > 0 and split > 0
    assert joint - split == real_forward


# -- optimizer ----------------------------------------------------------------


def test_adamw_and_lr_schedule_match_leaf_adamw():
    tc = TrainConfig(steps_per_epoch=2, lr_decay=0.5)  # flagship betas/eps
    jtc = JTrainConfig(steps_per_epoch=2, lr_decay=0.5)
    lr_ours = tstep.make_lr_schedule(Config(model=None, data=None, train=tc))
    lr_ref = j_lr_schedule(JConfig(model=None, data=None, train=jtc))
    for s in range(9):
        assert rel_err(lr_ours(s), lr_ref(jnp.asarray(s))) <= 1e-6
    rng = np.random.RandomState(9)
    tree = {"a": 0.01 * rng.randn(7, 3), "b": 0.01 * rng.randn(11),
            "c": 0.01 * rng.randn(1)}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    params = [torch.nn.Parameter(t(v)) for v in tree.values()]
    optim = tstep.make_optimizer(params, tc)
    tx = leaf_adamw(lr_ref, *jtc.betas, jtc.eps, weight_decay=0.01,
                    clip_value=jtc.grad_clip_value)
    jp = jax.tree.map(jnp.asarray, tree)
    js = tx.init(jp)
    for i in range(4):
        grads = {k: (3.0 * rng.randn(*v.shape)).astype(np.float32)
                 for k, v in tree.items()}  # some past the clip of 1
        for p, g in zip(params, grads.values()):
            p.grad = t(g)
        tstep.optimizer_step(optim, params, lr_ours(i), tc.grad_clip_value)
        upd, js = tx.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for p, r in zip(params, jp.values()):
            np.testing.assert_allclose(n(p), np.asarray(r), rtol=1e-6,
                                       atol=1e-9, err_msg=str(i))


# -- data ----------------------------------------------------------------------


def test_dataset_and_batcher_match_jax(tmp_path):
    rng = np.random.RandomState(10)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "filelists",
                           "ljs_audio_text_test_filelist.txt.cleaned"),
              encoding="utf-8") as f:
        texts = [line.rstrip("\n").split("|")[-1] for line in f][:9]
    rows = []
    for i, text in enumerate(texts):  # 20-650 frames: past the first edge
        path = str(tmp_path / f"{i}.wav")
        pcm = (_wave(rng, int(rng.randint(20, 650)) * 256 + int(
            rng.randint(0, 256))) * 32767).astype(np.int16)
        wavfile.write(path, 22050, pcm)
        rows.append(f"{path}|{text}")
    filelist = tmp_path / "list.txt"
    filelist.write_text("\n".join(rows) + "\n", encoding="utf-8")
    ds = TextAudioDataset(str(filelist), DataConfig(), seed=3,
                          device_spec=True)
    jds = JDataset(str(filelist), JDataConfig(), seed=3, device_spec=True)
    assert ds.rows == jds.rows and ds.lengths == jds.lengths
    ours, ref = BucketedBatcher(ds, 2), JBatcher(jds, 2)
    assert len(ours) == len(ref) > 1
    for epoch in (0, 1):
        assert ours.epoch_batches(epoch) == ref.epoch_batches(epoch)
        for got, want in zip(ours.iter_epoch(epoch), ref.iter_epoch(epoch)):
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- fake_slice and one whole step --------------------------------------------


def _posterior(m, y, y_lengths):
    """The first "noise" and "slice" draws of `Synthesizer.__call__`:
    (z, m_q, logs_q, y_mask, ids_slice)."""
    z, m_q, logs_q, y_mask = m.enc_q(y, y_lengths,
                                     noise_rng=m.make_rng("noise"),
                                     train=True)
    _, ids = j_rand_slice(z, m.make_rng("slice"), y_lengths,
                          m.cfg.segment_size)
    return z, m_q, logs_q, y_mask, ids


def _step_batch(seed=11, b=2, t_x=11, t_spec=40):
    """A collate-shaped device-spec batch: int16 wav sized
    t_spec * hop + (n_fft - hop), ragged lengths."""
    rng = np.random.RandomState(seed)
    t_wav = t_spec * 256 + 768
    lw = np.array([t_spec * 256 + 100, (t_spec - 8) * 256 + 50])
    wav = np.zeros((b, t_wav, 1), np.int16)
    for i in range(b):
        wav[i, :lw[i], 0] = (_wave(rng, lw[i]) * 32767).astype(np.int16)
    return {"x": rng.randint(1, 40, size=(b, t_x)).astype(np.int32),
            "x_lengths": np.array([t_x, t_x - 3], np.int32),
            "spec_lengths": np.minimum(lw // 256, t_spec).astype(np.int32),
            "wav": wav, "wav_lengths": lw.astype(np.int32)}


def _host_spec_batch(batch, t_spec=40):
    """The host-spec feed of `_step_batch`'s audio, as the host-spec
    collate lays it out: f32 wav [B, t_spec * hop, 1] and each row's host
    spectrogram in spec [B, t_spec, bins]."""
    b = len(batch["x"])
    wav = np.zeros((b, t_spec * 256, 1), np.float32)
    spec = np.zeros((b, t_spec, 513), np.float32)
    lw = np.minimum(batch["wav_lengths"], t_spec * 256)
    ls = np.zeros((b,), np.int32)
    for i in range(b):
        w = batch["wav"][i, :batch["wav_lengths"][i], 0] / 32768.0
        sp = _spectrogram_host(w.astype(np.float32), 1024, 256, 1024)
        ls[i] = min(len(sp), t_spec)
        spec[i, :ls[i]] = sp[:ls[i]]
        wav[i, :lw[i], 0] = w[:lw[i]]
    return dict(batch, wav=wav, spec=spec, spec_lengths=ls,
                wav_lengths=lw.astype(np.int32))


@pytest.fixture(scope="module", params=["pcm", "host_spec"])
def step_run(tmp_path_factory, request):
    """One JAX d_step + g_step and one port train_step from the same
    weights, batch and draws (lr 10 and eps 10: see test_train_step), on
    the feed of the param."""
    tmp = tmp_path_factory.mktemp("step")
    cfg_t, cfg_j = configs(p_dropout=0.0)
    params_g, model = make_weights(tmp, cfg_t, cfg_j)
    torch.manual_seed(12)
    net_d = MultiPeriodDiscriminator()
    params_d = _d_from_port(net_d, tmp)
    train = dict(learning_rate=10.0, eps=10.0, segment_size=SEG,
                 batch_size=2, steps_per_epoch=1)
    jcfg = JConfig(model=cfg_j, data=JDataConfig(),
                   train=JTrainConfig(**train))
    cfg = Config(model=cfg_t, data=DataConfig(), train=TrainConfig(**train))
    batch = _step_batch()
    if request.param == "host_spec":
        batch = _host_spec_batch(batch)

    # JAX: the two programs of make_train_step
    synth, jdisc = JSynthesizer(cfg_j), JMPD()
    tx_g, tx_d = make_optimizers(jcfg)
    jp_g = jax.tree.map(jnp.asarray, params_g)
    jp_d = jax.tree.map(jnp.asarray, params_d)
    rng = jax.random.PRNGKey(13)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params_g=jp_g,
                         params_d=jp_d, opt_state_g=tx_g.init(jp_g),
                         opt_state_d=tx_d.init(jp_d), rng=rng)
    jbatch = jax.tree.map(jnp.asarray, batch)
    # the step's draws, as make_train_step derives them (before g_step,
    # which donates the state and with it the key)
    k_noise, k_drop, k_slice = jax.random.split(
        jax.random.fold_in(rng, 0), 3)
    rngs = {"noise": k_noise, "dropout": k_drop, "slice": k_slice}
    step_fn = make_train_step(jcfg, synth, jdisc)
    d_out = step_fn.d_step(jstate, jbatch)
    d_ref = {"loss/d/total": float(d_out[2]), "grad_norm_d": float(d_out[3]),
             "params_d": jax.tree.map(np.array, d_out[0])}
    spec = np.asarray(d_out[4])
    new_state, g_metrics = step_fn.g_step(jstate, jbatch, *d_out)
    ref = {**d_ref, **{k: float(v) for k, v in g_metrics.items()},
           "params_g": jax.tree.map(np.array, new_state.params_g),
           "spec": spec}

    z, m_q, logs_q, y_mask, ids = japply(
        synth, params_g, spec, batch["spec_lengths"], method=_posterior,
        rngs=rngs)
    eps = np.where(y_mask > 0, (z - m_q) / np.exp(logs_q), 0.0).astype(
        np.float32)
    fake_ref = japply(synth, params_g, spec, batch["spec_lengths"],
                      method=JSynthesizer.fake_slice, rngs=rngs, train=True)

    # the port
    state = tstep.create_train_state(cfg, torch.device("cpu"), seed=0)
    state.net_g.load_state_dict(model.state_dict())
    state.net_d.load_state_dict(discriminator_state_dict_from_jax(params_d))
    init_g = {k: v.clone() for k, v in state.net_g.state_dict().items()}
    tbatch = {k: t(v) for k, v in batch.items()}
    prepped = tstep.prep_batch(tbatch, cfg)
    with torch.no_grad():
        fake = state.net_g.fake_slice(prepped["spec"],
                                      tbatch["spec_lengths"],
                                      posterior_eps=t(eps),
                                      ids_slice=t(ids))
    torch.manual_seed(14)  # the duration predictor's dropout
    metrics = tstep.train_step(state, tbatch,
                               tstep.StepDraws(t(eps), t(ids)))
    return dict(ref=ref, fake_ref=fake_ref, ids=ids, fake=fake,
                prepped=prepped, metrics=metrics, state=state, cfg=cfg_t,
                init_g=init_g)


def test_prep_batch_spectrogram_matches_jax(step_run):
    assert_close(n(step_run["prepped"]["spec"]), step_run["ref"]["spec"],
                 what="device spectrogram")
    wav = step_run["prepped"]["wav"]
    assert wav.dtype == torch.float32 and float(wav.abs().max()) <= 1.0


def test_fake_slice_matches_jax(step_run):
    (o, ids), (r_o, r_ids) = step_run["fake"], step_run["fake_ref"]
    np.testing.assert_array_equal(n(ids), r_ids)
    np.testing.assert_array_equal(r_ids, step_run["ids"])
    assert o.shape == r_o.shape == (2, SEG, 1)
    assert_close(n(o), r_o, what="fake")


def test_mas_neg_cent_is_float32_under_bf16_autocast():
    """fp16_run's bf16 autocast must not reach MAS's input: its terms are
    in the hundreds, and bf16 rounding would move alignment decisions."""
    rng = np.random.RandomState(15)
    z_p = t(3.0 * rng.randn(2, 16, 50).astype(np.float32))
    m_p = t(rng.randn(2, 16, 20).astype(np.float32))
    logs_p = t(0.3 * rng.randn(2, 16, 20).astype(np.float32))
    want = synthesizer.mas_neg_cent(z_p, m_p, logs_p)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = synthesizer.mas_neg_cent(z_p, m_p, logs_p)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


def test_train_step_matches_make_train_step(step_run):
    """One whole step against make_train_step's d_step and g_step.

    lr 10 and eps 10 make Adam's first update -(10 g / (|g| + 10) + 0.1 p),
    a smooth function of the gradient (Adam's usual first step is
    lr * sign(g), which hides gradient errors), so the updated leaves hold
    the gradients. The duration predictor's dropout cannot be drawn as JAX
    draws it, so loss/g/dur, loss/g/total, grad_norm_g and the dp.* leaves
    are only checked finite; nothing else depends on it (its input is
    detached). Tolerances: loss scalars and grad_norm_d 1e-4 relative, D
    leaves 1e-4 max-abs. Each other G leaf's update, less its weight decay,
    is held to the reference's in L2, relative 1e-4 (measured <= 4.3e-6),
    and must move by >= 1e-3 in L2 (measured >= 4.7e-2), so no leaf passes
    on a small gradient. The decoder's output conv is held at 1e-3: it sums
    the sub-band MR-STFT gradient over every frame, through a 683-point FFT
    in torch and a DFT matmul in JAX (1.8e-5 measured on its bias). The
    key projection's bias has no gradient (softmax ignores a shift shared
    by all keys), so both packages must leave it still."""
    ref, metrics, state = step_run["ref"], step_run["metrics"], \
        step_run["state"]
    assert state.step == 1
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    for k in ("loss/d/total", "grad_norm_d", "loss/g/gen", "loss/g/fm",
              "loss/g/mel", "loss/g/kl", "loss/g/subband", "learning_rate"):
        assert rel_err(metrics[k], ref[k]) <= REL, (k, float(metrics[k]),
                                                    ref[k])
    d_ref = discriminator_state_dict_from_jax(ref["params_d"])
    for k, v in state.net_d.state_dict().items():
        assert_close(n(v), n(d_ref[k]), what=k)
    g_ref = state_dict_from_jax(ref["params_g"], step_run["cfg"])
    compared = 0
    for k, v in state.net_g.state_dict().items():
        if k.startswith("dp."):
            assert torch.isfinite(v).all(), k
            continue
        # the gradient's part of the update: new - (1 - lr * 0.01) * p0
        p0 = n(step_run["init_g"][k]).astype(np.float64)
        d_ours = n(v).astype(np.float64) - 0.9 * p0
        d_ref = n(g_ref[k]).astype(np.float64) - 0.9 * p0
        if k in ZERO_GRAD_G:
            assert max(np.linalg.norm(d_ours), np.linalg.norm(d_ref)) \
                <= 1e-6, k
            continue
        size = np.linalg.norm(d_ref)
        assert size >= 1e-3, (k, size)  # far above f32 round-off
        rel = np.linalg.norm(d_ours - d_ref) / size
        assert rel <= (1e-3 if k.startswith(MRSTFT_LEAVES) else REL), \
            (k, rel)
        compared += 1
    assert compared > 200
