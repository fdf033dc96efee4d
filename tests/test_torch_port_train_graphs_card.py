"""The training step as CUDA graphs per batch signature (`train/graphs.py`)
on a card, at the tiny width of torch_port_data.py, batch 2, TF32 off.

A replayed step is held to the eager body from the same weights, draws
and dropout seed: at the whole-step bars (loss scalars 1e-4 relative, D
leaves 1e-4 max-abs, each G leaf's update 2e-4 relative in L2; lr 10 and
eps 10, so the update holds the gradient) with cuDNN's default
algorithms, and bit for bit under its deterministic ones with torch's
deterministic algorithms (the gradients of gather and of the embeddings
are scatter-adds, whose atomics add in any order otherwise); the compared
step is past an epoch boundary (lr_decay 0.5), so the replay must read
the decayed lr. The capturable AdamW, eagerly and replayed in a graph, is
held to the JAX package's `leaf_adamw` arithmetic (restated here in
float64 numpy: this file imports no JAX). Two buckets are captured once
each in one pool and replayed in turns; `draw_step`'s draws give the
step that draws them itself; a pair written by the card loads into an
eager CPU state and back. Needs a CUDA device and skips without one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_train_graphs_card.py
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from mb_istft_vits_torch.config import Config
from mb_istft_vits_torch.device import disable_tf32
from mb_istft_vits_torch.infer.graphs import WARMUP_ITERS
from mb_istft_vits_torch.ops import mas
from mb_istft_vits_torch.train import checkpoint
from mb_istft_vits_torch.train import step as tstep
from torch_port_data import write_tiny_config

LOSS_REL, D_ATOL, G_REL = 1e-4, 1e-4, 2e-4
CMP_TRAIN = dict(learning_rate=10.0, eps=10.0, steps_per_epoch=2,
                 lr_decay=0.5, batch_size=2)
CMP_STEP, CMP_LR = 2, 5.0  # step 2 of 2-step epochs: lr 10 * 0.5


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    disable_tf32()
    c = Config.from_json(write_tiny_config(str(
        tmp_path_factory.mktemp("train_graphs_card"))))
    return dataclasses.replace(c, train=dataclasses.replace(
        c.train, batch_size=2))


def _batch(cfg, t_spec=40, t_x=11, seed=3):
    d = cfg.data
    rng = np.random.RandomState(seed)
    t_wav = t_spec * d.hop_length + d.filter_length - d.hop_length
    batch = {"x": rng.randint(1, 40, (2, t_x)).astype(np.int32),
             "x_lengths": np.array([t_x, t_x - 3], np.int32),
             "wav": rng.randint(-8000, 8000, (2, t_wav, 1)).astype(np.int16),
             "spec_lengths": np.array([t_spec, t_spec - 6], np.int32)}
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _leaves(state):
    return {f"{net}.{k}": v for net, m in (("g", state.net_g),
                                           ("d", state.net_d))
            for k, v in m.state_dict().items()}


@contextlib.contextmanager
def _determinism(on):
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=on, allow_tf32=False):
            yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def _replay_and_eager(cfg, batch, deterministic):
    cmp = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, **CMP_TRAIN))
    with _determinism(deterministic):
        gs = tstep.create_train_state(cmp, torch.device("cuda"), seed=3)
        es = tstep.create_train_state(cmp, torch.device("cuda"), seed=3)
        init = {k: v.detach().clone() for k, v in _leaves(gs).items()}
        for _ in range(WARMUP_ITERS + 1):
            tstep.train_step(gs, batch)
        assert gs.graphs.captures == 1
        with torch.no_grad():  # back to the start, in place
            for k, v in _leaves(gs).items():
                v.copy_(init[k])
            for optim in (gs.optim_g, gs.optim_d):
                for st in optim.state.values():
                    for v in st.values():
                        v.zero_()
        gs.step = es.step = CMP_STEP
        replays = gs.graphs.replays
        n0 = dict(mas.launch_counts)
        torch.cuda.manual_seed(11)
        gm = tstep.train_step(gs, batch)
        launched = {k: mas.launch_counts[k] - n0[k] for k in n0}
        torch.cuda.manual_seed(11)
        em = tstep.train_step_eager(es, batch)
        torch.cuda.synchronize()
    assert gs.graphs.replays == replays + 1 and gs.graphs.captures == 1
    assert launched["mas_fused"] + launched["mas_fwd"] == 1
    assert float(gs.optim_g.param_groups[0]["lr"]) == CMP_LR
    return gm, em, gs, es, init


@pytest.mark.cuda
def test_replay_holds_the_eager_step_at_the_whole_step_bars(cfg):
    batch = _batch(cfg)
    gm, em, gs, es, init = _replay_and_eager(cfg, batch, False)
    for k, v in em.items():
        if k.startswith(("loss/", "grad_norm")):
            rel = abs(float(gm[k]) - float(v)) / max(abs(float(v)), 1e-12)
            assert rel <= LOSS_REL, k
    gl, el = _leaves(gs), _leaves(es)
    keep = 1.0 - CMP_LR * 0.01
    compared = 0
    for k, v in el.items():
        if k.startswith("d."):
            assert float((gl[k] - v).abs().max()) <= D_ATOL, k
            continue
        p0 = init[k].double()
        upd = v.double() - keep * p0
        size = float(upd.norm())
        if size < 1e-6:
            continue
        rel = float((gl[k].double() - keep * p0 - upd).norm()) / size
        assert rel <= G_REL, (k, rel)
        compared += 1
    assert compared > 100


@pytest.mark.cuda
def test_replay_is_bit_equal_to_the_eager_step_deterministic(cfg):
    batch = _batch(cfg)
    gm, em, gs, es, _ = _replay_and_eager(cfg, batch, True)
    assert all(torch.equal(gm[k].cpu(), em[k].cpu()) for k in em)
    gl, el = _leaves(gs), _leaves(es)
    unequal = {k: float((gl[k] - v).abs().max()) for k, v in el.items()
               if not torch.equal(gl[k], v)}
    assert not unequal, unequal


def _leaf_adamw(p, g, mu, nu, count, lr, b1, b2, eps, wd, clip):
    """The JAX package's `leaf_adamw` update of one leaf, in float64:
    clip, moments, bias correction at count + 1, weight decay, lr taken at
    the count before the increment."""
    if clip is not None:
        g = np.clip(g, -clip, clip)
    mu = b1 * mu + (1.0 - b1) * g
    nu = b2 * nu + (1.0 - b2) * g * g
    bc1, bc2 = 1.0 - b1 ** (count + 1), 1.0 - b2 ** (count + 1)
    adam = (mu / bc1) / (np.sqrt(nu / bc2) + eps)
    return p - lr * (adam + wd * p), mu, nu


@pytest.mark.cuda
@pytest.mark.parametrize("captured", [False, True])
def test_capturable_adamw_holds_leaf_adamw(cfg, captured):
    """4 steps of 3 leaves (gradients past the clip of 1), lr from the
    schedule (steps_per_epoch 2, lr_decay 0.5) written into the lr tensor
    before each step; eagerly, or the clip and update captured once and
    replayed."""
    tc = dataclasses.replace(cfg.train, steps_per_epoch=2, lr_decay=0.5)
    schedule = tstep.make_lr_schedule(dataclasses.replace(cfg, train=tc))
    rng = np.random.RandomState(9)
    shapes = [(7, 3), (11,), (1,)]
    ref = [(0.01 * rng.randn(*s)) for s in shapes]
    params = [torch.nn.Parameter(torch.tensor(v, dtype=torch.float32,
                                              device="cuda")) for v in ref]
    optim = tstep.make_optimizer(params, tc)
    assert optim.param_groups[0]["capturable"]
    lr_tensor = optim.param_groups[0]["lr"]
    assert isinstance(lr_tensor, torch.Tensor) and lr_tensor.is_cuda
    mu = [np.zeros(s) for s in shapes]
    nu = [np.zeros(s) for s in shapes]
    static = [torch.zeros(s, device="cuda") for s in shapes]
    graph = None
    for i in range(4):
        grads = [3.0 * rng.randn(*s) for s in shapes]
        for buf, g in zip(static, grads):
            buf.copy_(torch.tensor(g, dtype=torch.float32))
        tstep.set_lr(optim, schedule(i))
        if i == 0 or not captured:
            for p, buf in zip(params, static):
                p.grad = buf.clone() if p.grad is None else p.grad.copy_(buf)
            tstep.optimizer_step(optim, params, None, tc.grad_clip_value)
        else:
            if graph is None:
                graph = torch.cuda.CUDAGraph()
                side = torch.cuda.Stream()
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    graph.capture_begin(capture_error_mode="thread_local")
                    for p, buf in zip(params, static):
                        p.grad.copy_(buf)
                    tstep.optimizer_step(optim, params, None,
                                         tc.grad_clip_value)
                    graph.capture_end()
                torch.cuda.current_stream().wait_stream(side)
            graph.replay()
        for j in range(len(shapes)):
            g32 = grads[j].astype(np.float32).astype(np.float64)
            ref[j], mu[j], nu[j] = _leaf_adamw(
                ref[j], g32, mu[j], nu[j], i, schedule(i), *tc.betas,
                tc.eps, tstep.WEIGHT_DECAY, tc.grad_clip_value)
        torch.cuda.synchronize()
        for p, r in zip(params, ref):
            np.testing.assert_allclose(p.detach().cpu().numpy(), r,
                                       rtol=1e-5, atol=1e-9, err_msg=str(i))
    assert optim.param_groups[0]["lr"] is lr_tensor


@pytest.mark.cuda
def test_two_buckets_are_captured_once_each_in_one_pool(cfg):
    state = tstep.create_train_state(cfg, torch.device("cuda"), seed=1)
    short, long_ = _batch(cfg, t_spec=36), _batch(cfg, t_spec=44, t_x=13)
    for b in [short] * (WARMUP_ITERS + 1) + [long_] * (WARMUP_ITERS + 1):
        tstep.train_step(state, b)
    g = state.graphs
    assert g.captures == 2 and len(g) == 2 and len(g.keys()) == 2
    pool = g.pool
    assert all(v is not None and v > 0
               for v in g.pool_bytes_at_capture.values())
    n0 = mas.launch_counts["mas_fused"] + mas.launch_counts["mas_fwd"]
    replays = g.replays
    out = [tstep.train_step(state, b) for b in (short, long_, short, long_)]
    assert g.captures == 2 and g.replays == replays + 4 and g.pool is pool
    assert mas.launch_counts["mas_fused"] + mas.launch_counts["mas_fwd"] \
        == n0 + 4
    assert all(np.isfinite(float(v)) for m in out for v in m.values())


@pytest.mark.cuda
def test_draw_step_gives_the_step_that_draws_itself(cfg):
    batch = _batch(cfg)
    runs = []
    with _determinism(True):
        for explicit in (False, True):
            state = tstep.create_train_state(cfg, torch.device("cuda"),
                                             seed=5)
            torch.cuda.manual_seed(9)
            draws = tstep.draw_step(state, batch) if explicit else None
            m = tstep.train_step_eager(state, batch, draws)
            runs.append((m, _leaves(state)))
    (m0, l0), (m1, l1) = runs
    assert all(torch.equal(m0[k].cpu(), m1[k].cpu()) for k in m0)
    assert all(torch.equal(l0[k], l1[k]) for k in l0)


@pytest.mark.cuda
def test_a_card_pair_loads_into_a_cpu_state_and_back(cfg, tmp_path):
    batch = _batch(cfg)
    card = tstep.create_train_state(cfg, torch.device("cuda"), seed=2)
    for _ in range(WARMUP_ITERS + 1):
        tstep.train_step(card, batch)
    checkpoint.save(str(tmp_path / "card"), card)
    cpu = tstep.create_train_state(cfg, torch.device("cpu"), seed=4)
    assert checkpoint.resume(str(tmp_path / "card"), cpu) == 3
    m = tstep.train_step(cpu, {k: v.cpu() for k, v in batch.items()})
    assert all(np.isfinite(float(v)) for v in m.values())
    checkpoint.save(str(tmp_path / "cpu"), cpu)
    lr = card.optim_g.param_groups[0]["lr"]
    assert checkpoint.resume(str(tmp_path / "cpu"), card) == 4
    assert len(card.graphs) == 0  # new moments: the graphs went
    assert card.optim_g.param_groups[0]["lr"] is lr
    assert card.optim_g.param_groups[0]["capturable"]
    assert all(st["step"].is_cuda and float(st["step"]) == 4
               for st in card.optim_g.state.values())
    for _ in range(WARMUP_ITERS + 1):
        m = tstep.train_step(card, batch)
    assert card.graphs.captures == 2
    assert all(np.isfinite(float(v)) for v in m.values())
