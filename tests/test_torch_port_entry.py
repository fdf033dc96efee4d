"""The PyTorch port's entry points and package boundary on the CPU:
importing the port (every module) and loading chip_smoke.py pulls in no
JAX and nothing of mb_istft_vits_tpu; devices resolve to CUDA unless the
CPU is asked for; the serving module and its CLI run end to end."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from mb_istft_vits_torch import device as port_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_MODEL = dict(inter_channels=16, hidden_channels=16, filter_channels=32,
                  n_layers=1, upsample_initial_channel=32,
                  resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3, 5]])


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def imported():
    """Every port module, chip_smoke.py and the test ranks' worker imported
    in a fresh process (without torchrun's environment): the modules, any
    JAX module loaded, and whether a process group was started."""
    code = r"""
import importlib, importlib.util, pkgutil, sys, json
import mb_istft_vits_torch
names = [m.name for m in pkgutil.walk_packages(
    mb_istft_vits_torch.__path__, "mb_istft_vits_torch.")]
for name in names:
    importlib.import_module(name)
for path in ("chip_smoke.py", "tests/torch_port_dist_worker.py"):
    spec = importlib.util.spec_from_file_location("m", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax")
             or m.startswith("mb_istft_vits_tpu"))
import torch.distributed as dist
print(json.dumps({"modules": names, "bad": bad,
                  "process_group": dist.is_initialized()}))
"""
    env = {k: v for k, v in _env().items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_nothing_of_the_jax_package(imported):
    out = imported
    assert out["bad"] == []
    assert "mb_istft_vits_torch.models.synthesizer" in out["modules"]
    for name in ("synthesize", "synthesize_z", "batch_synthesize",
                 "serve.microbatch", "serve.streaming", "dsp.resample",
                 "utils.audio", "infer.synthesis", "text.jp",
                 "voice_conversion", "nn.transforms", "utils.metrics",
                 "utils.observability", "data.prefetch", "train.loop",
                 "train.checkpoint", "data.resident", "data.native_audio",
                 "utils.native_build", "utils.corpus", "eval_metrics",
                 "eval_checkpoint", "eval_vc", "preprocess", "make_corpus",
                 "parallel", "parallel.mesh", "parallel.tp",
                 "parallel.dryrun", "infer.export", "export_serving",
                 "infer.programs", "infer.graphs", "train.graphs",
                 "dsp", "dsp.pqmf", "dsp.stft", "dsp.mel", "overfit_check",
                 "make_tiny_dataset", "make_filelists", "analyze_phase",
                 "tb_extract", "utils.timing", "bench", "bench_train",
                 "bench_batch", "bench_stream", "bench_chunk_decode",
                 "bench_microbatch", "bench_export", "bench_mas",
                 "profile_step", "profile_infer", "flops_analysis"):
        assert f"mb_istft_vits_torch.{name}" in out["modules"]


def test_importing_the_port_starts_no_process_group(imported):
    assert imported["process_group"] is False


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError):
        port_device.resolve_device("cuda")
    assert port_device.resolve_device("cpu") == torch.device("cpu")


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    with open(os.path.join(REPO, "configs", "ljs_mb_istft_vits.json")) as f:
        cfg = json.load(f)
    cfg["model"].update(TINY_MODEL)
    path = tmp_path_factory.mktemp("cfg") / "tiny.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_synthesis_module_serves_int16_on_cpu(tiny_config):
    """float32 audio on the int16 grid (the PCM is quantized on the
    device, as in the JAX package), a multiple of the hop long."""
    from mb_istft_vits_torch.infer.synthesis import SynthesisModule

    sm = SynthesisModule(tiny_config, seed=3, device="cpu")
    text = "ðə kwˈɪk bɹˈaʊn fˈɑːks."
    audio, timings = sm.synthesize(text, seed=1)
    assert audio.dtype == np.float32
    pcm = audio * 32767.0
    np.testing.assert_array_equal(pcm, np.round(pcm))
    assert audio.size % 256 == 0 and audio.size > 0
    assert timings["frame_bucket"] * 256 > audio.size
    assert np.abs(audio).max() > 0
    assert timings["audio_seconds"] == pytest.approx(audio.size / 22050)
    again, _ = sm.synthesize(text, seed=1)
    np.testing.assert_array_equal(audio, again)  # reseeded: repeatable


def test_synthesize_cli_writes_a_wav(tiny_config, tmp_path):
    out = tmp_path / "out.wav"
    proc = subprocess.run(
        [sys.executable, "-m", "mb_istft_vits_torch.synthesize", "-c",
         tiny_config, "-t", "həlˈoʊ wˈɜːld.", "-o", str(out), "--device",
         "cpu"], cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    with wave.open(str(out)) as w:
        assert w.getsampwidth() == 2 and w.getframerate() == 22050
        assert w.getnframes() == report["samples"] > 0
        assert report["samples"] % 256 == 0
