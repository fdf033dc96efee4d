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
import subprocess
import sys

import pytest
import torch

from torch_port_data import write_tiny_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_LINE = re.compile(r"\bstep (\d+): (\{.*\})$")


def run_cli(cwd, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "mb_istft_vits_torch.train",
                           *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def step_metrics(stdout):
    """{step: metrics} of the CLI's per-step log lines."""
    return {int(m.group(1)): json.loads(m.group(2))
            for m in map(STEP_LINE.search, stdout.splitlines()) if m}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """4 steps, then a resumed run to step 6, in one model directory."""
    root = tmp_path_factory.mktemp("cli")
    cfg = write_tiny_dataset(str(root))
    first = run_cli(root, "-c", cfg, "-m", "tiny", "--device", "cpu",
                    "--max-steps", "4")
    second = run_cli(root, "-c", cfg, "-m", "tiny", "--device", "cpu",
                     "--max-steps", "6")
    return root, cfg, first, second


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
    assert (model_dir / "train.log").read_text().count("step 4:") == 1

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
    root, _, _, second = trained
    assert second.returncode == 0, second.stderr
    assert "resumed from step 4" in second.stdout
    metrics = step_metrics(second.stdout)
    assert sorted(metrics) == [5, 6]
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
                                               config.data), 2)
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
    assert "resumed from step 2" in second.stdout
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


def test_cli_without_a_card_refuses_to_run(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = write_tiny_dataset(str(tmp_path), n=2)
    proc = run_cli(tmp_path, "-c", cfg, "-m", "nocard", "--max-steps", "1")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "logs" / "nocard" / "G_1.pth").exists()
