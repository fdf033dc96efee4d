"""The port's training CLI on the CPU (`python -m mb_istft_vits_torch.train
--device cpu`): it takes steps with finite metrics, writes reference-format
checkpoints, resumes, and without --device refuses to run when there is
no card; a step of its data with `fp16_run` keeps float32 master weights.
Imports no JAX.

A tiny English dataset in tmp_path (torch_port_data.write_tiny_dataset,
which chip_smoke.py's CLI phase trains on too): 6 seeded int16 wavs and
rows of the cleaned LJSpeech test filelist, the model block shrunk as in
test_torch_port_entry.py, batch 2, a 2048-sample segment (the period
discriminators' widths are fixed, so the segment sets their cost).
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from torch_port_data import write_tiny_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_LINE = re.compile(r"\bstep (\d+): (\{.*\})$")


def cli_env():
    """The CLI's environment: the repo importable, and two torch threads,
    as fast as eight at this width when alone, and far faster when the
    suite's workers share the cores."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def run_cli(cwd, *args):
    return subprocess.run([sys.executable, "-m", "mb_istft_vits_torch.train",
                           *args], cwd=cwd, env=cli_env(),
                          capture_output=True, text=True, timeout=300)


def step_metrics(stdout):
    """{step: metrics} of the CLI's per-step log lines."""
    return {int(m.group(1)): json.loads(m.group(2))
            for m in map(STEP_LINE.search, stdout.splitlines()) if m}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """4 steps, then a resumed run to step 6, in one model directory, with
    an eval and a pair every step (so the runs prune); the first run's
    pair of step 4 is kept aside in root/step4 (a hard link: the second
    run replaces the file, not its contents). The directory is deleted
    after the module's tests: a pair is ~0.56 GB (the discriminator is
    full width)."""
    root = tmp_path_factory.mktemp("cli")
    cfg = write_tiny_dataset(str(root), eval_interval=1)
    first = run_cli(root, "-c", cfg, "-m", "tiny", "--device", "cpu",
                    "--max-steps", "4")
    kept = root / "step4"
    kept.mkdir()
    for p in "GD":
        os.link(root / "logs" / "tiny" / f"{p}_4.pth", kept / f"{p}_4.pth")
    second = run_cli(root, "-c", cfg, "-m", "tiny", "--device", "cpu",
                     "--max-steps", "6")
    yield root, cfg, first, second
    shutil.rmtree(root, ignore_errors=True)


def test_cli_takes_steps_and_writes_checkpoints(trained):
    root, cfg, first, _ = trained
    assert first.returncode == 0, first.stderr
    metrics = step_metrics(first.stdout)
    assert sorted(metrics) == [1, 2, 3, 4]
    for step, m in metrics.items():
        for k in ("loss/g/total", "loss/g/mel", "loss/g/subband",
                  "loss/d/total", "grad_norm_g", "grad_norm_d",
                  "learning_rate"):
            assert k in m, (step, k)
        assert all(math.isfinite(v) for v in m.values()), (step, m)
    model_dir = root / "logs" / "tiny"
    g = torch.load(model_dir / "G_4.pth", weights_only=True)
    d = torch.load(model_dir / "D_4.pth", weights_only=True, mmap=True)
    assert g["iteration"] == d["iteration"] == 4
    assert set(g) == {"model", "iteration", "optimizer", "learning_rate"}
    # once from each run: the resumed one replays step 4's epoch
    assert (model_dir / "train.log").read_text().count("step 4:") == 2

    # every generator weight moved away from its seeded init
    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.train.step import create_train_state

    config = Config.from_json(cfg)
    init = create_train_state(config, torch.device("cpu"),
                              config.train.seed).net_g.state_dict()
    assert sorted(init) == sorted(g["model"])
    unchanged = [k for k, v in init.items() if torch.equal(v, g["model"][k])]
    assert unchanged == []


def test_cli_resumes_from_the_newest_checkpoint(trained):
    """The pair of step 4 is in the second of two 3-step epochs, so the
    run restarts at that epoch's start and takes steps 4-6 again."""
    root, _, _, second = trained
    assert second.returncode == 0, second.stderr
    assert "resumed from step 4 (snapped to epoch boundary 3)" \
        in second.stdout
    metrics = step_metrics(second.stdout)
    assert sorted(metrics) == [4, 5, 6]
    assert all(math.isfinite(v) for m in metrics.values()
               for v in m.values())
    assert (root / "logs" / "tiny" / "G_6.pth").exists()
    assert (root / "logs" / "tiny" / "D_6.pth").exists()


def test_fp16_run_step_keeps_float32_master_weights(tmp_path):
    """`fp16_run: true` (bf16 autocast on the CPU): one step of the CLI's
    data and step, in this process, with finite metrics and moved float32
    weights."""
    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.data import BucketedBatcher, TextAudioDataset
    from mb_istft_vits_torch.train.step import create_train_state, train_step

    config = Config.from_json(write_tiny_dataset(str(tmp_path), seed=1,
                                                 fp16_run=True))
    assert config.train.fp16_run
    batcher = BucketedBatcher(TextAudioDataset(config.data.training_files,
                                               config.data, device_spec=True),
                              2)
    batch = {k: torch.from_numpy(v) for k, v in
             batcher.make_batch(*batcher.epoch_batches(0)[0]).items()}
    state = create_train_state(config, torch.device("cpu"), seed=0)
    before = [p.detach().clone() for p in state.net_g.parameters()]
    metrics = train_step(state, batch)
    assert all(math.isfinite(float(v)) for v in metrics.values()), metrics
    for net in (state.net_g, state.net_d):
        assert {p.dtype for p in net.parameters()} == {torch.float32}
    assert not any(torch.equal(a, b) for a, b in
                   zip(before, state.net_g.parameters()))


def test_cli_trains_a_japanese_multispeaker_config(tmp_path):
    """`uudb_ms_istft_vits_ms.json` shrunk: `path|sid|text` phoneme rows of
    six speakers, the MS-iSTFT head. The speaker embedding is trained, is
    saved in G_*.pth, and comes back on resume; the sub-band loss is 0."""
    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.train import checkpoint
    from mb_istft_vits_torch.train.step import create_train_state

    cfg = write_tiny_dataset(str(tmp_path), multi_speaker=True)
    first = run_cli(tmp_path, "-c", cfg, "-m", "ms", "--device", "cpu",
                    "--max-steps", "2")
    assert first.returncode == 0, first.stderr
    second = run_cli(tmp_path, "-c", cfg, "-m", "ms", "--device", "cpu",
                     "--max-steps", "3")
    assert second.returncode == 0, second.stderr
    # step 2 is inside the first 3-step epoch: the resumed run restarts it
    assert "resumed from step 2 (snapped to epoch boundary 0)" \
        in second.stdout
    assert sorted(step_metrics(second.stdout)) == [1, 2, 3]
    metrics = {**step_metrics(first.stdout), **step_metrics(second.stdout)}
    assert sorted(metrics) == [1, 2, 3]
    assert all(m["loss/g/subband"] == 0.0 for m in metrics.values())
    assert all(math.isfinite(v) for m in metrics.values()
               for v in m.values())
    model_dir = tmp_path / "logs" / "ms"
    g2 = torch.load(model_dir / "G_2.pth", weights_only=True)["model"]
    g3 = torch.load(model_dir / "G_3.pth", weights_only=True)["model"]
    config = Config.from_json(cfg)
    assert config.model.decoder_kind == "ms_istft"
    init = create_train_state(config, torch.device("cpu"),
                              config.train.seed).net_g
    assert g2["emb_g.weight"].shape == (12, 8)
    assert not torch.equal(g2["emb_g.weight"], init.emb_g.weight.detach())
    assert not torch.equal(g3["emb_g.weight"], g2["emb_g.weight"])
    state = create_train_state(config, torch.device("cpu"), 0)
    os.remove(model_dir / "G_3.pth")  # resume from step 2
    assert checkpoint.resume(str(model_dir), state) == 2
    assert torch.equal(state.net_g.emb_g.weight.detach(), g2["emb_g.weight"])


EVAL_LINE = re.compile(r"\beval: (\w+=.*)$")
EVAL_SCALARS = ("mcd_copy_synthesis", "lsd_copy_synthesis", "f0_rmse_hz",
                "voicing_decision_error", "mcd_tts_dtw", "dur_ratio_tts")


def eval_scalars(stdout):
    """[{scalar: value}] of the CLI's eval log lines, in order."""
    return [{k: float(v) for k, v in re.findall(r"(\w+)=(\S+)", m.group(1))}
            for m in map(EVAL_LINE.search, stdout.splitlines()) if m]


def pair_steps(model_dir):
    from mb_istft_vits_torch.train import checkpoint

    return checkpoint.saved_steps(str(model_dir))


@pytest.fixture(scope="module")
def reset_run(trained):
    """A third run in `trained`'s model directory, from step 6 to 8 with
    --reset-optimizer, on a config with an eval and a metrics line every
    2 steps."""
    root = trained[0]
    with open(trained[1]) as f:
        cfg = json.load(f)
    cfg["train"].update(eval_interval=2, log_interval=2)
    path = str(root / "every2.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return run_cli(root, "-c", path, "-m", "tiny", "--device", "cpu",
                   "--max-steps", "8", "--reset-optimizer")


def test_cli_evaluates_every_eval_interval_and_logs_every_log_interval(
        trained, reset_run):
    """An eval at every step of the first two runs and at step 8 only of
    the third (its eval_interval 2), each with the copy-synthesis MCD /
    LSD / F0 and the TTS output's DTW MCD and duration ratio in the log,
    with or without tensorboardX; the third run's metrics line at step 8
    only (its log_interval 2), with steps_per_sec."""
    _, _, first, second = trained
    assert reset_run.returncode == 0, reset_run.stderr
    counts = [len(eval_scalars(p.stdout)) for p in (first, second, reset_run)]
    assert counts == [4, 3, 1]
    for p in (first, second, reset_run):
        for scalars in eval_scalars(p.stdout):
            assert sorted(scalars) == sorted(EVAL_SCALARS)
            assert all(math.isfinite(v) for v in scalars.values()), scalars
            assert scalars["mcd_copy_synthesis"] > 0
    metrics = step_metrics(reset_run.stdout)
    assert sorted(metrics) == [8]
    assert metrics[8]["steps_per_sec"] > 0


def test_cli_records_the_best_pair_and_prunes_the_rest(trained, reset_run):
    """best.json names the pair of the lowest copy-synthesis MCD of the
    three runs, which is on disk; the pairs left are the newest 3 and
    that one."""
    root, _, first, second = trained
    model_dir = root / "logs" / "tiny"
    out = first.stdout + second.stdout + reset_run.stdout
    with open(model_dir / "best.json") as f:
        best = json.load(f)
    assert best["metric"] == "eval/mcd_copy_synthesis"
    records = re.findall(r"best checkpoint: step (\d+) ", out)
    assert records and int(records[-1]) == best["step"]
    mcds = [e["mcd_copy_synthesis"] for e in eval_scalars(out)]
    assert float(f"{best['value']:.3f}") == min(mcds)
    assert "pruned checkpoints:" in out
    assert pair_steps(model_dir) == sorted({5, 6, 8, best["step"]})


def test_cli_reset_optimizer_resumes_the_weights_with_fresh_optimizers(
        trained, reset_run):
    """The run from step 6 (an epoch boundary: no snap) keeps the weights
    and takes new optimizers: their step counts start at 0 (2 at step 8)
    and the lr schedule starts again from the initial lr."""
    from mb_istft_vits_torch.config import Config

    assert reset_run.returncode == 0, reset_run.stderr
    assert "resumed from step 6 (optimizer reset)" in reset_run.stdout
    lr0 = Config.from_json(trained[1]).train.learning_rate
    assert step_metrics(reset_run.stdout)[8]["learning_rate"] == \
        pytest.approx(lr0, rel=1e-6)
    g = torch.load(trained[0] / "logs" / "tiny" / "G_8.pth",
                   weights_only=True)
    steps = {int(s["step"]) for s in g["optimizer"]["state"].values()}
    assert steps == {2}


def test_resume_snaps_the_step_and_the_optimizer_counts_to_the_epoch(
        trained):
    """checkpoint.resume of the first run's pair of step 4, then
    snap_to_epoch (3 steps an epoch): the step and every AdamW step count
    go back to 3, so the lr stays the schedule's at 3; weights_only keeps
    fresh optimizers (no counts) and restarts the schedule there."""
    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.train import checkpoint
    from mb_istft_vits_torch.train.step import create_train_state, \
        make_lr_schedule

    config = Config.from_json(trained[1])
    kept = trained[0] / "step4"
    saved = torch.load(kept / "G_4.pth", weights_only=True)
    for weights_only in (False, True):
        state = create_train_state(config, torch.device("cpu"), 0)
        assert checkpoint.resume(str(kept), state, weights_only) == 4
        for k, v in state.net_g.state_dict().items():
            assert torch.equal(v, saved["model"][k]), k
        assert checkpoint.snap_to_epoch(state, 3) == state.step == 3
        counts = {int(s["step"]) for optim in (state.optim_g, state.optim_d)
                  for s in optim.state.values()}
        assert counts == (set() if weights_only else {3})
        assert state.lr_offset == (3 if weights_only else 0)
        sched = make_lr_schedule(config)
        assert state.learning_rate() == sched(0 if weights_only else 3)


def test_cli_checkpoints_and_exits_0_on_sigterm(tmp_path):
    """SIGTERM once the first metrics line is out: the run saves the pair
    of the step it is at and exits 0."""
    import signal

    cfg = write_tiny_dataset(str(tmp_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mb_istft_vits_torch.train", "-c", cfg, "-m",
         "term", "--device", "cpu", "--max-steps", "500"], cwd=tmp_path,
        env=cli_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if STEP_LINE.search(line.rstrip("\n")):
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    m = re.search(r"SIGTERM: checkpointed at step (\d+), exiting",
                  "".join(lines) + out)
    assert m, out
    step = int(m.group(1))
    assert 1 <= step < 500
    assert pair_steps(tmp_path / "logs" / "term") == [step]
    shutil.rmtree(tmp_path / "logs")


def test_cli_debug_nans_and_boundaries(tmp_path, monkeypatch):
    """In this process: --debug-nans runs every step in autograd's anomaly
    mode (and leaves it as it was after), --boundaries sets the batcher's
    bucket edges."""
    from mb_istft_vits_torch.train import loop
    from mb_istft_vits_torch.train.__main__ import main

    cfg = write_tiny_dataset(str(tmp_path), n=2)
    modes = []

    def recording_step(state, batch):
        modes.append(torch.is_anomaly_enabled())
        return train_step(state, batch)

    train_step = loop.train_step
    monkeypatch.setattr(loop, "train_step", recording_step)
    monkeypatch.chdir(tmp_path)
    assert main(["-c", cfg, "-m", "dbg", "--device", "cpu", "--max-steps",
                 "1", "--debug-nans", "--boundaries", "32,400"]) == 0
    assert modes == [True] and not torch.is_anomaly_enabled()
    log = (tmp_path / "logs" / "dbg" / "train.log").read_text()
    assert "buckets [32, 400]" in log
    assert pair_steps(tmp_path / "logs" / "dbg") == [1]
    shutil.rmtree(tmp_path / "logs")


@pytest.mark.parametrize("num_workers,depth", [(1, 1), (4, None)])
def test_prefetch_keeps_the_epoch_order(tmp_path, num_workers, depth):
    """The loader threads' batches, and their copies through
    device_prefetch, are the batcher's own, in its epoch-seeded order;
    an early close stops the threads."""
    import numpy as np

    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.data import (
        BucketedBatcher,
        TextAudioDataset,
        device_prefetch,
        prefetch_epoch,
    )

    config = Config.from_json(write_tiny_dataset(str(tmp_path), n=8))
    batcher = BucketedBatcher(TextAudioDataset(config.data.training_files,
                                               config.data, device_spec=True),
                              2)
    for epoch in (0, 1):
        want = list(batcher.iter_epoch(epoch))
        got = list(device_prefetch(prefetch_epoch(batcher, epoch,
                                                  num_workers, depth),
                                   device=torch.device("cpu")))
        assert len(got) == len(want) == len(batcher) == 4
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), w[k])
    it = iter(prefetch_epoch(batcher, 0, num_workers, depth))
    next(it)
    it.close()


def test_cli_without_a_card_refuses_to_run(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = write_tiny_dataset(str(tmp_path), n=2)
    proc = run_cli(tmp_path, "-c", cfg, "-m", "nocard", "--max-steps", "1")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "logs" / "nocard" / "G_1.pth").exists()
