"""The port's development tools against the JAX package's scripts on the
CPU: `overfit_check` (the tiny config and the seeded batch against the
script's, wav and spectrogram within 1e-4; a 2-step run with finite
losses; the gate; no card, no run), `make_tiny_dataset` and
`make_filelists` (byte-equal output), `analyze_phase` (the printed
statistics, numbers within 1e-4) and `tb_extract` (on tfevents that
tensorboardX writes; skipped only without `tensorboard`).

The JAX scripts run in this process with their `main()` and `sys.argv`;
the port's CLIs as child processes run with two torch threads, and each
test's files live in its own tmp dir, which it deletes.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import mb_istft_vits_tpu.train as jax_train

from mb_istft_vits_torch import (
    analyze_phase,
    make_filelists,
    make_tiny_dataset,
    overfit_check,
    tb_extract,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import scripts.analyze_phase as jax_analyze_phase  # noqa: E402
import scripts.make_filelists as jax_make_filelists  # noqa: E402
import scripts.make_tiny_dataset as jax_make_tiny_dataset  # noqa: E402
import scripts.overfit_check as jax_overfit_check  # noqa: E402
import scripts.tb_extract as jax_tb_extract  # noqa: E402


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


def _run_jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    module.main()


@pytest.fixture
def workdir(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


# -- overfit_check ---------------------------------------------------------------------


class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def jax_overfit_inputs():
    """The JAX script's config and batch: its `main()` up to
    `create_train_state`, which is replaced by a capture."""
    seen = {}

    def capture(cfg, rng, batch):
        seen.update(cfg=cfg, batch={k: np.asarray(v)
                                    for k, v in batch.items()})
        raise _Captured

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train, "create_train_state", capture)
        mp.setenv("MBIV_XLA_CACHE", "0")  # leave the suite's cache alone
        mp.setattr(sys, "argv", ["overfit_check.py", "--cpu"])
        with pytest.raises(_Captured):
            jax_overfit_check.main()
    return seen


def _fields(cfg):
    return {k: (list(map(list, v)) if k == "resblock_dilation_sizes"
                else list(v) if isinstance(v, (list, tuple)) else v)
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("part", ["model", "data", "train"])
def test_overfit_config_is_the_jax_script_s(jax_overfit_inputs, part):
    ours = getattr(overfit_check.tiny_config(), part)
    ref = getattr(jax_overfit_inputs["cfg"], part)
    assert _fields(ours) == _fields(ref)


def test_overfit_batch_is_the_jax_script_s(jax_overfit_inputs):
    ref = jax_overfit_inputs["batch"]
    ours = overfit_check.synthetic_batch(overfit_check.tiny_config())
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].shape == v.shape and ours[k].dtype == v.dtype, k
        if v.dtype.kind == "f":
            err = float(np.max(np.abs(ours[k] - v)))
            assert err <= 1e-4, (k, err)
        else:
            assert np.array_equal(ours[k], v), k


@pytest.fixture
def two_threads():
    """Two torch threads, as the suite's other CPU step tests use."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_overfit_runs_two_steps_on_the_cpu(capsys, two_threads):
    result = overfit_check.run(2, "cpu")
    out = capsys.readouterr().out
    assert "compile+step0:" in out and "mel loss:" in out
    assert len(result["step_ms"]) == 2
    assert all(np.isfinite(v) for v in result["metrics"].values())
    assert result["first_mel"] > 0 and np.isfinite(result["last_mel"])


@pytest.mark.parametrize("ratio", [0.5, 0.8])
def test_overfit_gate_is_the_jax_script_s(ratio, capsys):
    result = {"first_mel": 100.0, "last_mel": 100.0 * ratio}
    if ratio < 0.7:
        overfit_check.gate(result)
        assert "OVERFIT CHECK PASSED" in capsys.readouterr().out
    else:
        with pytest.raises(AssertionError, match="did not drop enough"):
            overfit_check.gate(result)


def test_overfit_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        overfit_check.main(["--steps", "1"])


# -- make_tiny_dataset, make_filelists ------------------------------------------------


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_make_tiny_dataset_is_byte_equal_to_the_jax_script(workdir):
    """Both into one directory (the filelist and config hold its path):
    the JAX script's files, then the port CLI's over them."""
    out = str(workdir / "tiny")
    jax_make_tiny_dataset.make(out)
    ref = _tree_bytes(out)
    proc = subprocess.run(
        [sys.executable, "-m", "mb_istft_vits_torch.make_tiny_dataset", out],
        cwd=REPO, env=_child_env(), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == os.path.join(out, "cfg.json")
    assert sorted(ref) == sorted(["cfg.json", "train.txt"]
                                 + [f"utt{i}.wav" for i in range(8)])
    assert _tree_bytes(out) == ref
    for fp16 in (True, False):  # in process, both precisions
        shutil.rmtree(out)
        jax_make_tiny_dataset.make(out, fp16_run=fp16)
        ref = _tree_bytes(out)
        shutil.rmtree(out)
        make_tiny_dataset.make(out, fp16_run=fp16)
        assert _tree_bytes(out) == ref


@pytest.mark.parametrize("layout", ["ljs", "multi_speaker"])
def test_make_filelists_is_byte_equal_to_the_jax_script(workdir, layout,
                                                        monkeypatch, capsys):
    corpus = workdir / "corpus"
    corpus.mkdir()
    with open(corpus / "metadata.csv", "w", encoding="utf-8") as f:
        for i in range(40):
            middle = f"Raw {i}." if layout == "ljs" else str(i % 4)
            f.write(f"LJ{i:03d}|{middle}|Normalized text {i}.\n")
    argv = ["--corpus", str(corpus), "--val", "5", "--test", "7"]
    if layout == "ljs":
        argv.append("--ljs-metadata")
    _run_jax_main(jax_make_filelists, argv + ["--out", str(workdir / "a/l")],
                  monkeypatch)
    ref_out = capsys.readouterr().out
    make_filelists.main(argv + ["--out", str(workdir / "b/l")])
    ours_out = capsys.readouterr().out
    assert ours_out == ref_out.replace(str(workdir / "a"), str(workdir / "b"))
    ref, ours = _tree_bytes(workdir / "a"), _tree_bytes(workdir / "b")
    assert sorted(ref) == [f"l_{s}_filelist.txt" for s in
                           ("test", "train", "val")]
    assert ours == ref


# -- analyze_phase, tb_extract ------------------------------------------------------------


_NUMBER = re.compile(r"-?\d+\.\d+|-?\d+")


def _same_report(ours, ref, tol=1e-4):
    """Equal line for line, numbers within `tol`."""
    ours, ref = ours.strip().splitlines(), ref.strip().splitlines()
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert _NUMBER.sub("#", a) == _NUMBER.sub("#", b), (a, b)
        for x, y in zip(_NUMBER.findall(a), _NUMBER.findall(b)):
            assert abs(float(x) - float(y)) <= tol, (a, b)


def test_analyze_phase_prints_the_jax_statistics(workdir, monkeypatch,
                                                 capsys):
    rng = np.random.RandomState(11)
    sr, n = 16000, 12000
    tone = np.sin(2 * np.pi * 440 * np.arange(n) / sr)
    paths = []
    for i, noise in enumerate((0.02, 0.2)):
        wav = (9000 * tone + 9000 * noise * rng.randn(n)).astype(np.int16)
        paths.append(str(workdir / f"w{i}.wav"))
        wavfile.write(paths[-1], sr, wav)
    argv = paths + ["--labels", "clean", "noisy", "--n-fft", "512",
                    "--hop", "128"]
    _run_jax_main(jax_analyze_phase, argv, monkeypatch)
    ref = capsys.readouterr().out
    analyze_phase.main(argv)
    ours = capsys.readouterr().out
    assert "dominant bin" in ours and "phase-diff std" in ours
    _same_report(ours, ref)


def test_tb_extract_reads_what_tensorboardx_writes(workdir, monkeypatch,
                                                   capsys):
    pytest.importorskip("tensorboard")
    from tensorboardX import SummaryWriter

    logdir = str(workdir / "logs")
    with SummaryWriter(logdir) as w:
        for step in range(0, 300, 10):
            w.add_scalar("loss/g/mel", 40.0 - step / 10, step)
            w.add_scalar("eval/mcd", 9.0 - step / 100, step)
    for tags in ([], ["loss/g/mel", "eval/mcd"]):
        argv = [logdir, *tags, "--max-rows", "6"]
        _run_jax_main(jax_tb_extract, argv, monkeypatch)
        ref = capsys.readouterr().out
        tb_extract.main(argv)
        assert capsys.readouterr().out == ref
        assert ref.count("\n") == (2 if not tags else 8)
