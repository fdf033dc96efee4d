"""The training step as CUDA graphs per batch signature (`train/graphs.py`,
`train/step.py`'s `draw_step`, `write_lr` and routing, the checkpoint
repair for a capturable optimizer, `ops/mas.py`'s replay launch rule), on
the CPU, where `train_step` runs the body directly and keeps the keys.

Tiny configs (the shrunk flagship, its SDP variant and the shrunk
12-speaker model) at batch 2 and two torch threads. Tolerances: bit for
bit (torch.equal) where the port is held to itself; against JAX's
`d_step` and `g_step`, the whole-step bars of the card's comparisons:
loss scalars 1e-4 relative, D leaves 1e-4 max-abs, each G leaf's update
(less its weight decay, lr 10) 2e-4 relative in L2.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mb_istft_vits_tpu.config import Config as JConfig
from mb_istft_vits_tpu.config import DataConfig as JDataConfig
from mb_istft_vits_tpu.config import TrainConfig as JTrainConfig
from mb_istft_vits_tpu.models import MultiPeriodDiscriminator as JMPD
from mb_istft_vits_tpu.models import Synthesizer as JSynthesizer
from mb_istft_vits_tpu.train.step import TrainState as JTrainState
from mb_istft_vits_tpu.train.step import make_optimizers, make_train_step

from mb_istft_vits_torch.config import Config, DataConfig, TrainConfig
from mb_istft_vits_torch.infer.graphs import WARMUP_ITERS
from mb_istft_vits_torch.models import MultiPeriodDiscriminator
from mb_istft_vits_torch.ops import mas
from mb_istft_vits_torch.parallel import shard_train_state_dp
from mb_istft_vits_torch.train import checkpoint
from mb_istft_vits_torch.train import graphs as tgraphs
from mb_istft_vits_torch.train import step as tstep
from mb_istft_vits_torch.weights import (
    discriminator_state_dict_from_jax,
    state_dict_from_jax,
)

from tests.test_torch_port_train import _d_from_port, _posterior, _step_batch
from tests.torch_port_common import configs, japply, make_weights, n, t
from tests.torch_port_data import (MS_CONFIG, drop_checkpoints,
                                   write_tiny_config)

LOSS_REL, D_ATOL, G_REL = 1e-4, 1e-4, 2e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _tiny_config(tmp, config=None, **model) -> Config:
    """A shrunk shipped config (torch_port_data), batch 2, the model block
    updated with `model` and `fp16_run` popped into the train block."""
    fp16 = model.pop("fp16_run", False)
    cfg = Config.from_json(write_tiny_config(str(tmp), config)
                           if config else write_tiny_config(str(tmp)))
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model),
        train=dataclasses.replace(cfg.train, batch_size=2, fp16_run=fp16,
                                  steps_per_epoch=2, lr_decay=0.5))


def _batch(cfg: Config, t_spec: int = 40, t_x: int = 11, seed: int = 3):
    """A collate-shaped device-spec batch of 2 rows, ragged."""
    d = cfg.data
    rng = np.random.RandomState(seed)
    t_wav = t_spec * d.hop_length + d.filter_length - d.hop_length
    batch = {"x": torch.from_numpy(
                 rng.randint(1, 40, (2, t_x)).astype(np.int32)),
             "x_lengths": torch.tensor([t_x, t_x - 3], dtype=torch.int32),
             "wav": torch.from_numpy(rng.randint(
                 -8000, 8000, (2, t_wav, 1)).astype(np.int16)),
             "spec_lengths": torch.tensor([t_spec, t_spec - 6],
                                          dtype=torch.int32)}
    if cfg.model.n_speakers:
        batch["sid"] = torch.tensor([3, 7], dtype=torch.int32)
    return batch


def _leaves(state):
    return {f"{net}.{k}": v for net, m in (("g", state.net_g),
                                           ("d", state.net_d))
            for k, v in m.state_dict().items()}


VARIANTS = {
    "flagship": (None, {}),
    "sdp": (None, {"use_sdp": True}),
    "12_speakers": (MS_CONFIG, {}),
    "fp16_run": (None, {"fp16_run": True}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_draw_step_gives_the_eager_step(tmp_path, variant):
    """The draws of `draw_step`, passed in, give the step that draws them
    itself (the body's generator, in its order and dtypes) bit for bit:
    every metric and every leaf after two steps."""
    config, model = VARIANTS[variant]
    cfg = _tiny_config(tmp_path, config, **dict(model))
    batch = _batch(cfg)
    runs = []
    for explicit in (False, True):
        state = tstep.create_train_state(cfg, torch.device("cpu"), seed=5)
        torch.manual_seed(9)  # dropout
        metrics = []
        for _ in range(2):
            draws = tstep.draw_step(state, batch) if explicit else None
            metrics.append(tstep.train_step_eager(state, batch, draws))
        runs.append((metrics, _leaves(state)))
    (m0, l0), (m1, l1) = runs
    for a, b in zip(m0, m1):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (variant, k)
    assert all(torch.equal(l0[k], l1[k]) for k in l0), variant
    draws = tstep.draw_step(state, batch)
    assert draws.posterior_eps.shape == (2, 40, cfg.model.inter_channels)
    assert draws.ids_slice.dtype == torch.int32
    assert (draws.sdp_eps is not None) == cfg.model.use_sdp


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """JAX's d_step + g_step, the routed `train_step` and the eager body
    from the same weights, batch and JAX's draws (lr 10 and eps 10, as in
    test_torch_port_train's whole-step test)."""
    tmp = tmp_path_factory.mktemp("graphs_step")
    cfg_t, cfg_j = configs(p_dropout=0.0)
    params_g, model = make_weights(tmp, cfg_t, cfg_j)
    torch.manual_seed(12)
    net_d = MultiPeriodDiscriminator()
    params_d = _d_from_port(net_d, tmp)
    train = dict(learning_rate=10.0, eps=10.0, segment_size=2048,
                 batch_size=2, steps_per_epoch=1)
    jcfg = JConfig(model=cfg_j, data=JDataConfig(),
                   train=JTrainConfig(**train))
    cfg = Config(model=cfg_t, data=DataConfig(), train=TrainConfig(**train))
    batch = _step_batch()

    synth, jdisc = JSynthesizer(cfg_j), JMPD()
    tx_g, tx_d = make_optimizers(jcfg)
    jp_g = jax.tree.map(jnp.asarray, params_g)
    jp_d = jax.tree.map(jnp.asarray, params_d)
    rng = jax.random.PRNGKey(13)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params_g=jp_g,
                         params_d=jp_d, opt_state_g=tx_g.init(jp_g),
                         opt_state_d=tx_d.init(jp_d), rng=rng)
    jbatch = jax.tree.map(jnp.asarray, batch)
    k_noise, k_drop, k_slice = jax.random.split(
        jax.random.fold_in(rng, 0), 3)
    rngs = {"noise": k_noise, "dropout": k_drop, "slice": k_slice}
    step_fn = make_train_step(jcfg, synth, jdisc)
    d_out = step_fn.d_step(jstate, jbatch)
    ref = {"loss/d/total": float(d_out[2]), "grad_norm_d": float(d_out[3])}
    ref_d = jax.tree.map(np.array, d_out[0])
    spec = np.asarray(d_out[4])
    new_state, g_metrics = step_fn.g_step(jstate, jbatch, *d_out)
    ref.update({k: float(v) for k, v in g_metrics.items()})
    ref_g = jax.tree.map(np.array, new_state.params_g)
    z, m_q, logs_q, y_mask, ids = japply(
        synth, params_g, spec, batch["spec_lengths"], method=_posterior,
        rngs=rngs)
    eps = np.where(y_mask > 0, (z - m_q) / np.exp(logs_q), 0.0).astype(
        np.float32)

    out = {}
    for route, fn in (("routed", tstep.train_step),
                      ("eager", tstep.train_step_eager)):
        state = tstep.create_train_state(cfg, torch.device("cpu"), seed=0)
        state.net_g.load_state_dict(model.state_dict())
        state.net_d.load_state_dict(
            discriminator_state_dict_from_jax(params_d))
        init_g = {k: v.clone() for k, v in state.net_g.state_dict().items()}
        torch.manual_seed(14)  # the duration predictor's dropout
        metrics = fn(state, {k: t(v) for k, v in batch.items()},
                     tstep.StepDraws(t(eps), t(ids)))
        out[route] = (state, metrics)
    return dict(ref=ref, ref_d=ref_d, ref_g=ref_g, cfg=cfg_t, init_g=init_g,
                **out)


def test_routed_step_equals_the_eager_body(jax_step):
    (rs, rm), (es, em) = jax_step["routed"], jax_step["eager"]
    assert rm.keys() == em.keys()
    assert all(torch.equal(rm[k], em[k]) for k in rm)
    rl, el = _leaves(rs), _leaves(es)
    assert all(torch.equal(rl[k], el[k]) for k in rl)
    assert rs.step == es.step == 1
    assert rs.graphs is not None and len(rs.graphs.keys()) == 1
    assert rs.graphs.captures == 0 and es.graphs is None


def test_routed_step_holds_jax_at_the_whole_step_bars(jax_step):
    """Loss scalars (but those the duration predictor's dropout reaches:
    dur, total, grad_norm_g), D leaves and G leaves' updates outside dp.*
    and the leaves without a gradient."""
    state, metrics = jax_step["routed"]
    ref = jax_step["ref"]
    for k in ("loss/d/total", "grad_norm_d", "loss/g/gen", "loss/g/fm",
              "loss/g/mel", "loss/g/kl", "loss/g/subband", "learning_rate"):
        rel = abs(float(metrics[k]) - ref[k]) / max(abs(ref[k]), 1e-12)
        assert rel <= LOSS_REL, (k, float(metrics[k]), ref[k])
    d_ref = discriminator_state_dict_from_jax(jax_step["ref_d"])
    for k, v in state.net_d.state_dict().items():
        assert float((v - d_ref[k]).abs().max()) <= D_ATOL, k
    g_ref = state_dict_from_jax(jax_step["ref_g"], jax_step["cfg"])
    compared = 0
    for k, v in state.net_g.state_dict().items():
        if k.startswith("dp."):
            continue
        p0 = n(jax_step["init_g"][k]).astype(np.float64)
        upd_ref = n(g_ref[k]).astype(np.float64) - 0.9 * p0
        size = np.linalg.norm(upd_ref)
        if size < 1e-6:
            continue
        upd = n(v).astype(np.float64) - 0.9 * p0
        # the decoder's output conv: a 683-point FFT in torch, a DFT
        # matmul in JAX (test_torch_port_train holds it at 1e-3)
        bar = 1e-3 if k.startswith("dec.subband_conv_post.") else G_REL
        assert np.linalg.norm(upd - upd_ref) / size <= bar, k
        compared += 1
    assert compared > 200


def test_two_buckets_two_keys_and_a_repeat_adds_none(tmp_path):
    cfg = _tiny_config(tmp_path)
    state = tstep.create_train_state(cfg, torch.device("cpu"), seed=1)
    short, long_ = _batch(cfg, t_spec=36), _batch(cfg, t_spec=44, t_x=13)
    for b in (short, long_, short, long_):
        tstep.train_step(state, b)
    keys = state.graphs.keys()
    assert len(keys) == 2 and state.step == 4
    assert {k[-1][2][0] for k in keys} == {
        tuple(short["wav"].shape), tuple(long_["wav"].shape)}
    for k in keys:  # variant, fp16_run, mas_force, device
        assert k[:7] == ("train", "MultibandISTFTGenerator", False, 0,
                         False, "auto", torch.device("cpu"))
    fp16 = dataclasses.replace(state, cfg=dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, fp16_run=True)))
    tstep.train_step(fp16, short)
    assert len(state.graphs.keys()) == 3  # one TrainGraphs, a new key
    state.mas_force = "two_pass"
    tstep.train_step(state, short)
    assert len(state.graphs.keys()) == 4
    assert {k[5] for k in state.graphs.keys()} == {"auto", "two_pass"}
    assert state.graphs.captures == 0 and state.graphs.replays == 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_a_data_parallel_state_is_not_routed(tmp_path):
    """(Named for the eager route such a state once took.) A data-parallel
    state of a one-rank gloo group is routed: its step goes through
    `TrainGraphs` in three stages with their two collectives, its key
    records world 1 and gloo, and its step is the plain state's."""
    cfg = _tiny_config(tmp_path)
    batch = _batch(cfg)
    plain = tstep.create_train_state(cfg, torch.device("cpu"), seed=2)
    assert tgraphs.routed(plain)
    torch.manual_seed(4)
    want = tstep.train_step(plain, batch, tstep.draw_step(plain, batch))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        state = shard_train_state_dp(
            tstep.create_train_state(cfg, torch.device("cpu"), seed=2))
        assert tgraphs.routed(state)
        assert len(tstep.step_stages(state, batch)) == 3
        torch.manual_seed(4)
        got = tstep.train_step(state, batch, tstep.draw_step(state, batch))
    finally:
        dist.destroy_process_group()
    (key,) = state.graphs.keys()
    assert key[7:9] == (1, "gloo")
    assert plain.graphs.keys()[0][7:9] == (1, None)
    assert plain.grad_buffers == {}  # no collective, no flat buffer
    assert state.step == 1 and set(state.grad_buffers) == {"d", "g"}
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * max(
            1.0, abs(float(want[k]))), k


def _capturable_by_hand(state):
    """The optimizers as a card holds them: each group's lr a 0-dim
    tensor and capturable on (the CPU's AdamW cannot step so)."""
    for optim in (state.optim_g, state.optim_d):
        for g in optim.param_groups:
            g["lr"] = torch.tensor(float(g["lr"]))
            g["capturable"] = True


def test_resume_drops_the_graphs_and_a_reset_or_snap_writes_in_place(
        tmp_path):
    cfg = _tiny_config(tmp_path)
    batch = _batch(cfg)
    state = tstep.create_train_state(cfg, torch.device("cpu"), seed=3)
    for _ in range(3):
        tstep.train_step(state, batch)
    model_dir = str(tmp_path / "ckpt")
    checkpoint.save(model_dir, state)
    key = state.graphs.keys()

    # weights only (--reset-optimizer): copied into the same parameters
    ptrs = [p.data_ptr() for p in state.net_g.parameters()]
    moments = {id(v) for st in state.optim_g.state.values()
               for v in st.values()}
    assert checkpoint.resume(model_dir, state, weights_only=True) == 3
    assert [p.data_ptr() for p in state.net_g.parameters()] == ptrs
    assert state.graphs.keys() == key

    # the epoch snap: the step counts move in place
    steps = [st["step"] for st in state.optim_g.state.values()]
    assert checkpoint.snap_to_epoch(state, 2) == 2
    assert all(st["step"] is s and float(s) == 2.0
               for st, s in zip(state.optim_g.state.values(), steps))
    assert state.graphs.keys() == key

    # the optimizers: new moments, so the graphs go
    assert checkpoint.resume(model_dir, state) == 3
    assert not {id(v) for st in state.optim_g.state.values()
                for v in st.values()} & moments
    assert state.graphs.keys() == [] and len(state.graphs) == 0
    tstep.train_step(state, batch)
    assert state.graphs.keys() == key
    drop_checkpoints(model_dir)


def test_a_capturable_pair_loads_into_an_eager_cpu_state_and_back(
        tmp_path):
    """A reference-format pair written from a card's capturable optimizers
    (lr tensors, capturable on) holds a CPU AdamW's state dict and loads
    into an eager CPU state, which then steps; a CPU-written pair loaded
    into capturable optimizers keeps their lr tensors (filled with the
    saved lr) and capturable flag."""
    cfg = _tiny_config(tmp_path)
    batch = _batch(cfg)
    card = tstep.create_train_state(cfg, torch.device("cpu"), seed=4)
    tstep.train_step(card, batch)
    _capturable_by_hand(card)
    model_dir = str(tmp_path / "pair")
    checkpoint.save(model_dir, card)
    for prefix in "GD":
        sd = torch.load(os.path.join(model_dir, f"{prefix}_1.pth"),
                        weights_only=True)["optimizer"]
        assert all(isinstance(g["lr"], float) and not g["capturable"]
                   for g in sd["param_groups"])
        assert all(st["step"].device.type == "cpu"
                   and float(st["step"]) == 1.0
                   for st in sd["state"].values())

    cpu = tstep.create_train_state(cfg, torch.device("cpu"), seed=6)
    assert checkpoint.resume(model_dir, cpu) == 1
    assert checkpoint._adam_steps(cpu.optim_g) == 1
    drop_checkpoints(model_dir)
    metrics = tstep.train_step(cpu, batch)
    assert all(np.isfinite(float(v)) for v in metrics.values())

    back = tstep.create_train_state(cfg, torch.device("cpu"), seed=7)
    _capturable_by_hand(back)
    lrs = [g["lr"] for g in back.optim_g.param_groups]
    cpu_dir = str(tmp_path / "cpu_pair")
    checkpoint.save(cpu_dir, cpu)
    assert checkpoint.resume(cpu_dir, back) == 2
    for g, lr in zip(back.optim_g.param_groups, lrs):
        assert g["lr"] is lr and g["capturable"]
        assert float(lr) == np.float32(tstep.make_lr_schedule(cfg)(1))
    assert all(st["step"].dtype == torch.float32 and float(st["step"]) == 2
               for st in back.optim_g.state.values())
    drop_checkpoints(cpu_dir)


def test_the_lr_follows_the_schedule_across_an_epoch(tmp_path):
    """steps_per_epoch 2, lr_decay 0.5: each step's lr, as the step reports
    it and as the optimizers hold it; a tensor lr is filled in place."""
    cfg = _tiny_config(tmp_path)
    batch = _batch(cfg)
    state = tstep.create_train_state(cfg, torch.device("cpu"), seed=8)
    lr0 = cfg.train.learning_rate
    for i in range(5):
        metrics = tstep.train_step(state, batch)
        want = lr0 * 0.5 ** (i // 2)
        assert float(metrics["learning_rate"]) == pytest.approx(want)
        assert all(g["lr"] == pytest.approx(want)
                   for o in (state.optim_g, state.optim_d)
                   for g in o.param_groups)
    lr = torch.tensor(1.0)
    optim = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(2))], lr=lr)
    tstep.set_lr(optim, 0.25)
    assert optim.param_groups[0]["lr"] is lr and float(lr) == 0.25


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replays_add_the_launches_their_capture_counted():
    """A capture's MAS launches leave the counts (a capture launches
    nothing) and each replay adds them: on a stubbed graph."""
    mas.reset_launch_counts()
    mas.launch_counts["mas_fused"] = 5
    with mas.captured_launches() as launches:
        mas.launch_counts["mas_fused"] += 1  # the wrapper, while captured
        mas.launch_counts["mas_fwd"] += 1
        mas.launch_counts["mas_bwd"] += 1
    assert mas.launch_counts == {"mas_fused": 5, "mas_fwd": 0, "mas_bwd": 0,
                                 "mas_path": 0}
    assert launches == {"mas_fused": 1, "mas_fwd": 1, "mas_bwd": 1,
                        "mas_path": 0}
    buf = torch.zeros(3)
    metrics = torch.tensor([1.5, 2.0])
    g = tgraphs._TrainGraph([_StubGraph()], [buf, None], metrics,
                            ("loss/d/total", "loss/g/gen"),
                            (torch.float32, torch.bfloat16), launches)
    plain = types.SimpleNamespace(group=None)  # a plain state: no collectives
    for i in range(3):
        out = g.replay(plain, [torch.full((3,), float(i)), None])
        assert torch.equal(buf, torch.full((3,), float(i)))
    assert g.graphs[0].replays == 3
    assert mas.launch_counts == {"mas_fused": 8, "mas_fwd": 3, "mas_bwd": 3,
                                 "mas_path": 0}
    assert out["loss/g/gen"].dtype == torch.bfloat16
    assert float(out["loss/d/total"]) == 1.5
    out["loss/d/total"] += 1  # a copy: the graph's buffer is not written
    assert float(metrics[0]) == 1.5
    mas.reset_launch_counts()


def test_drive_needs_a_collective_between_each_two_parts():
    """A plain state runs any number of parts back to back; a data-parallel
    or sharded state driven with a part count that does not match its
    collectives raises before any part runs (its reductions would be
    dropped)."""
    from mb_istft_vits_torch.train.step import drive
    ran = []
    plain = types.SimpleNamespace(group=None)
    assert drive(plain, lambda i: ran.append(i) or i, 3) == 2
    assert ran == [0, 1, 2]
    dp = types.SimpleNamespace(group=object(), shards={})
    sharded = types.SimpleNamespace(group=object(), shards={
        "d": types.SimpleNamespace(gather=None),
        "g": types.SimpleNamespace(gather=None)})
    for state, n in ((dp, 1), (dp, 5), (sharded, 1), (sharded, 3)):
        with pytest.raises(ValueError, match="collectives"):
            drive(state, ran.append, n)
    assert ran == [0, 1, 2]


def test_warmup_steps_before_a_capture():
    assert WARMUP_ITERS >= 1
    assert tgraphs.STEP_KEYS == ("x", "x_lengths", "wav", "spec",
                                 "spec_lengths", "sid")
