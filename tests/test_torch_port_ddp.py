"""Data-parallel training of the PyTorch port on the CPU: two gloo ranks
(subprocesses of tests/torch_port_dist_worker.py, which import the port
only) each step on one row of tests/test_torch_port_train.py's batch of
two ragged rows, against the port's single-process step on both rows and
against the JAX package's `make_train_step` on them (the unsharded JAX
step is the function its mesh step runs, tests/test_train.py:182).

The weights are the worker's `seeded_state`, which each rank builds
itself; the draws are JAX's global draws, and each rank takes its row.
Every dropout is off in both packages, lr 10 and eps 10
(tests/test_torch_port_train.py explains why). Bars: loss scalars 1e-4
relative, D leaves 1e-4 max-abs, G leaves outside dp.* 2e-4 relative L2
of their update (tests/test_torch_port_train.py's whole-step bars). The
ranks' rows differ in length (x 11 and 8 ids, 40 and 32 frames), so the
KL and duration losses hold the step to the global batch's
normalisation: per-rank normalisation misses them by far more than the
bar. Also: the CLI with two CPU ranks (rank 0 alone logs and checkpoints;
SIGTERM to rank 1 stops both at one step with a pair) and the resident
feeder's rows per rank.
"""

from __future__ import annotations

import concurrent.futures
import re
import shutil
import signal
import sys
import time

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mb_istft_vits_tpu.config import Config as JConfig
from mb_istft_vits_tpu.config import DataConfig as JDataConfig
from mb_istft_vits_tpu.config import TrainConfig as JTrainConfig
from mb_istft_vits_tpu.models import MultiPeriodDiscriminator as JMPD
from mb_istft_vits_tpu.models import Synthesizer as JSynth
from mb_istft_vits_tpu.train.step import TrainState as JTrainState
from mb_istft_vits_tpu.train.checkpoint import import_torch_generator
from mb_istft_vits_tpu.train.step import make_optimizers, make_train_step

from mb_istft_vits_torch.config import Config, DataConfig, TrainConfig
from mb_istft_vits_torch.data import (
    BucketedBatcher,
    DeviceResidentFeeder,
    TextAudioDataset,
)
from mb_istft_vits_torch.parallel import dryrun
from mb_istft_vits_torch.train import checkpoint
from mb_istft_vits_torch.train import step as tstep
from mb_istft_vits_torch.weights import (
    discriminator_state_dict_from_jax,
    load_generator_pth,
    state_dict_from_jax,
)

from tests import torch_port_dist_worker as worker
from tests.test_torch_port_train import (
    REL,
    SEG,
    ZERO_GRAD_G,
    _d_from_port,
    _posterior,
    _step_batch,
    rel_err,
)
from tests.test_torch_port_variants_train import _NoDropout
from tests.torch_port_common import assert_close, configs, japply, n, t
from tests.torch_port_data import write_tiny_dataset

G_REL = 2e-4
LOSSES = ("loss/d/total", "grad_norm_d", "loss/g/gen", "loss/g/fm",
          "loss/g/mel", "loss/g/kl", "loss/g/dur", "loss/g/subband",
          "loss/g/total", "grad_norm_g", "learning_rate")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads in this process, as in the ranks it starts: the
    suite's workers share the cores, and eight threads a worker stall on
    every small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


SEED = 0  # the weights: worker.seeded_state, in the ranks and here


def _jax_generator(net_g, tmp, cfg_j):
    """port G -> reference G_*.pth -> the JAX package's importer."""
    path = str(tmp / "G_0.pth")
    torch.save({"model": net_g.state_dict(), "iteration": 0,
                "learning_rate": 2e-4, "optimizer": None}, path)
    return import_torch_generator(path, cfg_j)


def _row_ratio_losses(state, batch, draws, r):
    """loss/g/kl and loss/g/dur of row r alone, normalised by its own
    masks (what a rank would log without the global normalisation)."""
    rows = tstep.prep_batch({k: v[r:r + 1] for k, v in batch.items()},
                            state.cfg)
    with torch.no_grad():
        out = tstep.g_forward(state, rows, tstep.StepDraws(
            draws[0][r:r + 1], draws[1][r:r + 1]))
        losses = tstep.g_losses(state, rows, out, tstep.real_slice(
            state, rows, out[4]))
    return {k: float(losses[k]) for k in ("loss/g/kl", "loss/g/dur")}


@pytest.fixture(scope="module")
def ddp_run(tmp_path_factory):
    """JAX's step, the port's single-process step, each row's own KL and
    duration losses, and two DDP ranks (two steps: the compared one on
    JAX's draws; then one from the same weights at the default lr and
    eps, on the ranks' own draws), from one set of weights, batch and
    draws. The ranks build the weights themselves from SEED; their files
    go when the module's tests are done."""
    tmp = tmp_path_factory.mktemp("ddp")
    cfg_t, cfg_j = configs(p_dropout=0.0)
    train = dict(learning_rate=10.0, eps=10.0, segment_size=SEG,
                 batch_size=1, steps_per_epoch=1)
    jcfg = JConfig(model=cfg_j, data=JDataConfig(),
                   train=JTrainConfig(**train))
    cfg = Config(model=cfg_t, data=DataConfig(), train=TrainConfig(**train))
    init = worker.seeded_state(cfg, "cpu", SEED, dp_dropout=0.0)
    params_g = _jax_generator(init.net_g, tmp, cfg_j)
    params_d = _d_from_port(init.net_d, tmp)
    batch = _step_batch()

    synth, jdisc = JSynth(cfg_j), JMPD()
    rng = jax.random.PRNGKey(13)
    k_noise, k_drop, k_slice = jax.random.split(
        jax.random.fold_in(rng, 0), 3)
    rngs = {"noise": k_noise, "dropout": k_drop, "slice": k_slice}
    # the step's draws: its spectrogram is the port's own (held to JAX's
    # in tests/test_torch_port_train.py)
    spec = n(tstep.prep_batch({k: t(v) for k, v in batch.items()},
                              cfg)["spec"])
    z, m_q, logs_q, y_mask, ids = japply(
        synth, params_g, spec, batch["spec_lengths"], method=_posterior,
        rngs=rngs)
    eps = np.where(y_mask > 0, (z - m_q) / np.exp(logs_q), 0.0).astype(
        np.float32)
    draws = tstep.StepDraws(t(eps), t(ids))
    tbatch = {k: t(v) for k, v in batch.items()}

    out = tmp / "ranks"
    out.mkdir()
    spec_ranks = dict(world=2, device="cpu", backend="gloo", timeout=240,
                      cfg=cfg, seed=SEED, batch=tbatch, draws=draws,
                      dp_dropout=0.0,
                      # then a step at the config's lr and eps
                      steps=1, restart=Config(
                          model=cfg_t, data=DataConfig(),
                          train=TrainConfig(segment_size=SEG, batch_size=1)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(worker.launch, spec_ranks, str(out), 300)

        tx_g, tx_d = make_optimizers(jcfg)
        jp_g = jax.tree.map(jnp.asarray, params_g)
        jp_d = jax.tree.map(jnp.asarray, params_d)
        jstate = JTrainState(step=jnp.zeros((), jnp.int32), params_g=jp_g,
                             params_d=jp_d, opt_state_g=tx_g.init(jp_g),
                             opt_state_d=tx_d.init(jp_d), rng=rng)
        jbatch = jax.tree.map(jnp.asarray, batch)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(flax_nn, "Dropout", _NoDropout)
            step_fn = make_train_step(jcfg, synth, jdisc)
            d_out = step_fn.d_step(jstate, jbatch)
            # read before g_step, which donates the state
            ref = {"loss/d/total": float(d_out[2]),
                   "grad_norm_d": float(d_out[3]),
                   "d": discriminator_state_dict_from_jax(jax.tree.map(
                       np.array, d_out[0]))}
            new_state, g_metrics = step_fn.g_step(jstate, jbatch, *d_out)
        ref.update({k: float(v) for k, v in g_metrics.items()})
        ref["g"] = state_dict_from_jax(jax.tree.map(
            np.array, new_state.params_g), cfg_t)

        init_g = {k: v.clone() for k, v in init.net_g.state_dict().items()}
        per_row = [_row_ratio_losses(init, tbatch, draws, r)
                   for r in range(2)]
        single = init
        single_metrics = {k: float(v) for k, v in
                          tstep.train_step(single, tbatch, draws).items()}
        ranks = ranks.result()
    yield dict(ref=ref, single=single, single_metrics=single_metrics,
               per_row=per_row, ranks=ranks, init_g=init_g, batch=batch)
    shutil.rmtree(tmp, ignore_errors=True)


def _g_update_rel(ours, ref, p0):
    """|update(ours) - update(ref)| / |update(ref)|, the update less its
    weight decay (lr 10: new - 0.9 p0)."""
    p0 = n(p0).astype(np.float64)
    d_ours = n(ours).astype(np.float64) - 0.9 * p0
    d_ref = n(ref).astype(np.float64) - 0.9 * p0
    size = np.linalg.norm(d_ref)
    return np.linalg.norm(d_ours - d_ref) / max(size, 1e-30), size


@pytest.mark.parametrize("against", ["single_process", "jax"])
def test_ddp_step_matches_the_global_step(ddp_run, against):
    """Rank 0's weights after the first step, and the metrics it reports,
    against the single-process step on the global batch and against JAX's
    (every dropout off in both, so loss/g/dur and grad_norm_g are held
    too)."""
    rank0 = ddp_run["ranks"][0]
    if against == "jax":
        ref = ddp_run["ref"]
    else:
        ref = dict(ddp_run["single_metrics"],
                   g=ddp_run["single"].net_g.state_dict(),
                   d=ddp_run["single"].net_d.state_dict())
    metrics = rank0["compared"][0]["metrics"]
    for k in LOSSES:
        assert rel_err(metrics[k], ref[k]) <= REL, (k, metrics[k], ref[k])
    for k, v in rank0["d"][0].items():
        assert_close(n(v), n(ref["d"][k]), what=k)
    compared = 0
    for k, v in rank0["g"][0].items():
        if k.startswith("dp."):
            assert torch.isfinite(v).all(), k
            continue
        rel, size = _g_update_rel(v, ref["g"][k], ddp_run["init_g"][k])
        if k in ZERO_GRAD_G:
            assert size <= 1e-6, k
            continue
        assert size >= 1e-3, (k, size)
        assert rel <= G_REL, (k, rel)
        compared += 1
    assert compared > 200


def test_ddp_ragged_kl_and_dur_are_the_global_batchs(ddp_run):
    """The ranks' mask sums differ, the logged KL and duration losses are
    the global batch's, and the per-rank normalisation (the mean of each
    row's own ratio) misses them by more than 10x the bar."""
    lens = ddp_run["batch"]
    assert lens["x_lengths"][0] != lens["x_lengths"][1]
    assert lens["spec_lengths"][0] != lens["spec_lengths"][1]
    glob, per_row = ddp_run["single_metrics"], ddp_run["per_row"]
    for rank in ddp_run["ranks"]:
        metrics = rank["compared"][0]["metrics"]
        for k in ("loss/g/kl", "loss/g/dur"):
            assert rel_err(metrics[k], glob[k]) <= REL, k
            naive = np.mean([m[k] for m in per_row])
            assert rel_err(naive, glob[k]) > 10 * REL, (k, naive, glob[k])


def test_ddp_ranks_stay_bit_identical(ddp_run):
    """After every step both ranks hold the same weights, bit for bit, and
    report the same finite metrics; no MAS kernel runs on the CPU."""
    r0, r1 = ddp_run["ranks"]
    steps0, steps1 = (r["compared"] + r["steps"] for r in (r0, r1))
    assert len(steps0) == len(steps1) == 2
    for s0, s1 in zip(steps0, steps1):
        assert s0["digest"] == s1["digest"]
        assert s0["metrics"] == s1["metrics"]
        assert all(np.isfinite(v) for v in s0["metrics"].values())
        assert s0["mas_launches"] == s1["mas_launches"] == 0  # the CPU twin
    assert steps0[0]["digest"] != steps0[1]["digest"]


def test_resident_feeder_gathers_each_ranks_rows(tmp_path):
    """For each rank of two, the resident feeder's batches are that rank's
    host batches (`epoch_batches`), bit for bit; a mesh that is not one
    device per rank is refused."""
    cfg_path = write_tiny_dataset(str(tmp_path), n=12)
    cfg = Config.from_json(cfg_path)
    ds = TextAudioDataset(cfg.data.training_files, cfg.data, seed=0,
                          device_spec=True)
    for rank in range(2):
        batcher = BucketedBatcher(ds, 2, num_replicas=2, rank=rank)
        feeder = DeviceResidentFeeder(batcher, ["cpu", "cpu"],
                                      device="cpu")
        for epoch in range(2):
            got = list(feeder.iter_epoch(epoch))
            want = [batcher.make_batch(b, idx)
                    for b, idx in batcher.epoch_batches(epoch)]
            assert len(got) == len(want) == len(batcher) > 0
            for g, w in zip(got, want):
                assert sorted(g) == sorted(w)
                for k in w:
                    np.testing.assert_array_equal(n(g[k]), w[k], err_msg=k)
    with pytest.raises(ValueError, match="each rank"):
        DeviceResidentFeeder(batcher, ["cpu"] * 3, device="cpu")


# -- the CLI on two CPU ranks ----------------------------------------------------


def _cli_ranks(cfg, cwd, name, max_steps, world=2):
    """The training CLI as `world` CPU ranks, started as torchrun starts
    them (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)."""
    port = str(dryrun.free_port())
    return dryrun.start_ranks(
        lambda r: [sys.executable, "-m", "mb_istft_vits_torch.train", "-c",
                   cfg, "-m", name, "--max-steps", str(max_steps),
                   "--device", "cpu"], world,
        env=lambda r: dict(RANK=str(r), LOCAL_RANK=str(r),
                           WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                           MASTER_PORT=port),
        cwd=cwd, merge_stderr=True)


@pytest.fixture
def cli_dir(tmp_path):
    """tmp_path, emptied after the test: a CLI pair holds the full
    multi-period discriminator and its AdamW moments (about 0.6 GB)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _finish(procs, timeout=240):
    results = dryrun.finish_ranks(procs, timeout)
    return [rc for rc, _, _ in results], [out for _, out, _ in results]


def test_cli_two_ranks_log_and_save_on_rank_0(cli_dir):
    """Two CPU ranks to step 4 (3 steps an epoch a rank: 12 rows, batch 2 x
    2 ranks): exit codes 0, metric lines and the pair from rank 0 only,
    with the reference's names, and a single-process state resumes from
    it."""
    cfg = write_tiny_dataset(str(cli_dir), n=12)
    rcs, outs = _finish(_cli_ranks(cfg, str(cli_dir), "dp", 4))
    assert rcs == [0, 0], outs
    model_dir = cli_dir / "logs" / "dp"
    log = (model_dir / "train.log").read_text()
    steps = [int(s) for s in re.findall(r"step (\d+): \{", log)]
    assert steps == [1, 2, 3, 4], log
    assert "process group: 2 rank(s) over gloo, a global batch of 4" in log
    assert "3 steps/epoch" in log
    assert re.findall(r"step \d+: \{", outs[0]) and not re.findall(
        r"step \d+: \{", outs[1])
    assert checkpoint.saved_steps(str(model_dir)) == [4]
    sd = load_generator_pth(str(model_dir / "G_4.pth"))
    assert not any(k.startswith("module.") for k in sd)
    # the pair resumes a single-process state
    state = tstep.create_train_state(Config.from_json(cfg),
                                     torch.device("cpu"), seed=0)
    assert checkpoint.resume(str(model_dir), state) == 4
    for k, v in state.net_g.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_cli_sigterm_to_rank_1_stops_both_at_one_step(cli_dir):
    """SIGTERM to rank 1 once rank 0 has logged a step: both ranks stop at
    the same step boundary, rank 0 writes that step's pair, both exit 0."""
    cfg = write_tiny_dataset(str(cli_dir), n=12)
    procs = _cli_ranks(cfg, str(cli_dir), "term", 500)
    lines = []
    try:
        deadline = time.monotonic() + 240
        for line in procs[0].stdout:
            lines.append(line)
            if re.search(r"\bstep \d+: \{", line):
                procs[1].send_signal(signal.SIGTERM)
                break
            assert time.monotonic() < deadline
        rcs, outs = _finish(procs)
    finally:
        dryrun.kill_ranks(procs)
    out = "".join(lines) + outs[0]
    assert rcs == [0, 0], out + outs[1]
    m = re.search(r"SIGTERM: checkpointed at step (\d+), exiting", out)
    assert m, out
    stopped = int(m.group(1))
    assert stopped < 500
    assert checkpoint.saved_steps(str(cli_dir / "logs" / "term")) \
        == [stopped]
    logged = [int(s) for s in re.findall(r"step (\d+): \{", out)]
    assert logged[-1] == stopped
