"""The port's exported serving artifact (`infer/export.py`) on the CPU.

The flagship config shrunk to the tiny width, one seeded
reference-format `.pth`, the buckets of tests/test_export.py (text
(32, 64), frames (64, 128, 256)), so the default pairs are (32, 128) and
(64, 256). The artifact is held to the live port module bit for bit at a
seed and at the same frame bucket, and to the JAX package's live
`SynthesisModule` on the same weights at zero noise (1e-3 relative L2,
equal frames and bucket; JAX's own artifact equals its live module bit
for bit, tests/test_export.py). The stochastic duration predictor
(also against JAX, noise-free), speakers and bf16 round-trip at a seed. No program file holds a weight.
Also the CLI, and the compiler's version in the native build keys.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from mb_istft_vits_torch import kernels
from mb_istft_vits_torch.config import Config
from mb_istft_vits_torch.infer import synthesis as port_serving
from mb_istft_vits_torch.infer.export import (
    ExportedServing,
    export_serving,
    load_serving,
)
from mb_istft_vits_torch.utils import native_build
from mb_istft_vits_tpu.config import Config as JConfig
from mb_istft_vits_tpu.infer import synthesis as ref_serving

from tests.test_torch_port_variants_serve import _shrink, _tiny_json
from tests.torch_port_common import WAV_REL_L2, make_weights, rel_l2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["həlˈoʊ wˈɜːld.", "ðə kwˈɪk bɹˈaʊn fˈɑːks."]
JP_TEXT = "k o N n i t i w a"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads in this process: the suite's workers share the
    cores, and eight threads a worker stall on every small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _live(root, name="ljs_mb_istft_vits.json", dtype=torch.float32,
          **model):
    """(live port module on the CPU, config path, JAX params) of a tiny
    config with seeded weights."""
    path = _tiny_json(root, name, **model)
    params, _ = make_weights(root, Config.from_json(path).model,
                             JConfig.from_json(path).model)
    live = port_serving.SynthesisModule(path, str(root / "G_0.pth"), None, 0,
                                        dtype, device="cpu")
    return _shrink(live), path, params


@pytest.fixture(scope="module")
def flagship(tmp_path_factory):
    """(live module, artifact dir, manifest, served artifact, config path,
    JAX params): the default pairs."""
    root = tmp_path_factory.mktemp("export")
    live, path, params = _live(root)
    art = str(root / "artifact")
    manifest = export_serving(live, art)
    return live, art, manifest, load_serving(art, device="cpu"), path, params


def _at_bucket(live, served, text, *args, **kw):
    """The live module's request with its frame buckets those the artifact
    exported for the text's bucket (the probe picks the frame bucket), so
    both decode at one bucket."""
    fbs = served._buckets_for(len(served.text_to_ids(text)))[1]
    old = live.FRAME_BUCKETS
    live.FRAME_BUCKETS = tuple(fbs)
    live._frames_per_token, live._ratio_observed = 3.0, False
    try:
        return live.synthesize(text, *args, **kw)
    finally:
        live.FRAME_BUCKETS = old


def test_artifact_layout_and_manifest(flagship):
    _, art, manifest, _, _, _ = flagship
    assert manifest["pairs"] == [[32, 128], [64, 256]]
    assert sorted(os.listdir(art)) == [
        "infer_t32_f128.pt2", "infer_t64_f256.pt2", "manifest.json",
        "params.pt", "probe_t32.pt2", "probe_t64.pt2"]
    with open(os.path.join(art, "manifest.json")) as f:
        assert json.load(f) == manifest
    assert manifest["torch_version"] == torch.__version__
    assert manifest["platforms"] == ["cpu"] and manifest["device"] == "cpu"
    assert manifest["compute_dtype"] == "float32"
    assert manifest["n_speakers"] == 0 and not manifest["use_sdp"]
    assert manifest["frontend"]["serving_cleaners"] == ["english_cleaners2"]


def test_round_trip_equals_the_live_module_bit_for_bit(flagship):
    live, _, _, served, _, _ = flagship
    buckets = set()
    for text in TEXTS:
        want, tw = _at_bucket(live, served, text, seed=7)
        got, tg = served.synthesize(text, seed=7)
        assert tg["frame_bucket"] == tw["frame_bucket"]
        buckets.add(tg["frame_bucket"])
        assert got.dtype == np.float32 and len(got) > 0
        np.testing.assert_array_equal(got, want)
        assert set(tg) == {"total", "audio_seconds", "rtf", "frame_bucket"}
        again, _ = served.synthesize(text, seed=7)
        np.testing.assert_array_equal(again, got)
    assert buckets == {128, 256}  # both programs ran


def test_unseeded_requests_roll_and_overflow_raises(flagship):
    _, _, _, served, _, _ = flagship
    r1, _ = served.synthesize(TEXTS[0])
    r2, _ = served.synthesize(TEXTS[0])
    assert len(r1) != len(r2) or not np.array_equal(r1, r2)
    with pytest.raises(ValueError, match="exceeds every exported frame"):
        served.synthesize(TEXTS[0], seed=7, length_scale=50.0)
    with pytest.raises(ValueError, match="exceeds every exported text"):
        served.synthesize(" ".join(TEXTS * 4), seed=7)


def _archive_bytes(path):
    """(bytes of tensor data, entries) of a .pt2 archive: its weights,
    constants and example inputs."""
    with zipfile.ZipFile(path) as z:
        data = [i for i in z.infolist()
                if "/data/" in i.filename and not i.filename.endswith(".json")]
        return sum(i.file_size for i in data), [i.filename for i in data]


def test_no_program_holds_a_weight(flagship):
    _, art, _, _, _, _ = flagship
    params = os.path.getsize(os.path.join(art, "params.pt"))
    programs = [f for f in os.listdir(art) if f.endswith(".pt2")]
    assert len(programs) == 4
    for f in programs:
        assert os.path.getsize(os.path.join(art, f)) < params, f
        nbytes, entries = _archive_bytes(os.path.join(art, f))
        # weights none, example inputs none: the PQMF filters (4 x 63
        # float32) are the only tensor kept
        assert nbytes <= 4 * 63 * 4, (f, entries)


def test_artifact_matches_the_jax_live_module_at_zero_noise(flagship):
    _, _, _, served, path, params = flagship
    theirs = _shrink(ref_serving.SynthesisModule(path, params=params))
    for text in TEXTS:
        want, tw = _at_bucket(theirs, served, text, noise_scale=0.0, seed=0)
        got, tg = served.synthesize(text, noise_scale=0.0, seed=0)
        assert tg["frame_bucket"] == tw["frame_bucket"]
        assert got.shape == want.shape and len(got) > 0
        assert rel_l2(got, want) <= WAV_REL_L2


VARIANTS = {
    "sdp": dict(model=dict(use_sdp=True)),
    "multi_speaker": dict(name="uudb_ms_istft_vits_ms.json",
                          model=dict(gin_channels=8)),
    "bf16": dict(dtype=torch.bfloat16),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_round_trips_at_a_seed(variant, tmp_path):
    spec = VARIANTS[variant]
    live, path, params = _live(tmp_path,
                               spec.get("name", "ljs_mb_istft_vits.json"),
                               spec.get("dtype", torch.float32),
                               **spec.get("model", {}))
    art = str(tmp_path / "artifact")
    manifest = export_serving(live, art, pairs=[(32, 128)])
    served = load_serving(art, device="cpu")
    multi = live.cfg.n_speakers > 1
    text = JP_TEXT if multi else TEXTS[0]
    outs = []
    for sid in ((0, 5) if multi else (None,)):
        want, tw = _at_bucket(live, served, text, sid, seed=7)
        got, tg = served.synthesize(text, sid, seed=7)
        assert tg["frame_bucket"] == tw["frame_bucket"] == 128
        np.testing.assert_array_equal(got, want)
        outs.append(got)
    if multi:  # speakers change the PCM
        assert manifest["n_speakers"] == live.cfg.n_speakers
        assert not np.array_equal(outs[0], outs[1])
    if variant == "sdp":  # the predictor's noise moves the frames
        assert manifest["use_sdp"]
        quiet, _ = served.synthesize(text, seed=7, noise_scale_w=0.0)
        assert len(quiet) != len(outs[0]) or not np.array_equal(quiet,
                                                                outs[0])
        # noise-free, against JAX's live module on the same weights
        theirs = _shrink(ref_serving.SynthesisModule(path, params=params))
        kw = dict(noise_scale=0.0, noise_scale_w=0.0, seed=0)
        want, tw = _at_bucket(theirs, served, text, **kw)
        got, tg = served.synthesize(text, **kw)
        assert tg["frame_bucket"] == tw["frame_bucket"]
        assert got.shape == want.shape and len(got) > 0
        assert rel_l2(got, want) <= WAV_REL_L2
    stored = torch.load(os.path.join(art, "params.pt"), weights_only=True)
    live_sd = live.model.state_dict()
    assert list(stored) == list(live_sd)
    assert all(stored[k].dtype == v.dtype and torch.equal(stored[k], v)
               for k, v in live_sd.items())
    if variant == "bf16":
        assert manifest["compute_dtype"] == "bfloat16"
        assert stored["enc_p.emb.weight"].dtype == torch.bfloat16


def test_default_device_is_cuda_and_a_broken_artifact_raises(flagship,
                                                             tmp_path):
    _, art, _, _, _, _ = flagship
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ExportedServing(art)
    broken = str(tmp_path / "broken")
    shutil.copytree(art, broken)
    os.remove(os.path.join(broken, "infer_t64_f256.pt2"))
    with pytest.raises(FileNotFoundError):
        load_serving(broken, device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        export_serving(flagship[0], str(tmp_path / "tpu"), platforms=["tpu"])


def test_cli_exports_and_prints_its_line(flagship, tmp_path):
    _, _, _, _, path, _ = flagship
    out = str(tmp_path / "cli")
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "mb_istft_vits_torch.export_serving",
           "-c", path, "-k", os.path.join(os.path.dirname(path), "G_0.pth"),
           "-o", out,
           "--pairs", "32:64", "--platforms", "cpu", "cuda"]
    proc = subprocess.run([*cmd, "--device", "cpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = proc.stdout.strip().splitlines()[-1]
    assert line.startswith(
        f"exported 1 bucket pairs for platforms ['cpu', 'cuda'] to {out} (")
    assert line.endswith(" MB)")
    assert sorted(os.listdir(out)) == ["infer_t32_f64.pt2", "manifest.json",
                                       "params.pt", "probe_t32.pt2"]
    if not torch.cuda.is_available():  # CUDA unless --device cpu
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr


# -- the toolchain in the native build keys ------------------------------------


def test_kernel_build_key_covers_the_nvcc_version(monkeypatch):
    keys = []
    for version in ("release 12.4, V12.4.131", "release 12.4, V12.4.131",
                    "release 12.8, V12.8.93"):
        monkeypatch.setattr(kernels, "nvcc_version", lambda v=version: v)
        keys.append(kernels.library_path())
    assert keys[0] == keys[1] != keys[2]
    assert all(os.path.dirname(k) == kernels.BUILD_DIR for k in keys)


def test_kernel_build_key_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    kernels.nvcc_version.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kernels.library_path()
    finally:
        kernels.nvcc_version.cache_clear()


def test_native_build_key_covers_the_gxx_version(monkeypatch):
    src = os.path.join(REPO, "mb_istft_vits_torch", "csrc", "audio.cpp")
    keys = []
    for version in ("g++ (Debian 12.2.0-14) 12.2.0", "g++ (Debian 12.2.0-14) "
                    "12.2.0", "g++ (GCC) 14.1.0"):
        monkeypatch.setattr(native_build, "gxx_version", lambda v=version: v)
        keys.append(native_build.library_path(src, "audio"))
    assert keys[0] == keys[1] != keys[2]
