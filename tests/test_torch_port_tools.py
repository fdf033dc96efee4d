"""The port's offline tools against the JAX package's scripts on the CPU:
`eval_metrics` (scores and JSON of `scripts/eval_metrics.py`),
`eval_checkpoint` (the JSON schema of `scripts/eval_checkpoint.py`, and
its per-utterance scores with JAX's draws injected), the corpus renderer
`utils.corpus` and `make_corpus` (bit for bit against
`scripts/make_corpus.py`), `eval_vc` on a tiny 12-speaker model, and
`preprocess` (byte-equal to `preprocess.py`).

The JAX scripts run in this process with their `main()` and `sys.argv`.
Tolerances: scores of the same wavs 1e-4 relative; scores of the port's
decodes against JAX's with the same draws 1e-2 relative (the decodes
agree to 1e-3 relative L2, and the metrics amplify it).
"""

from __future__ import annotations

import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from mb_istft_vits_tpu.config import Config as JConfig
from mb_istft_vits_tpu.models import Synthesizer as JSynthesizer

from mb_istft_vits_torch import (
    eval_checkpoint,
    eval_metrics,
    eval_vc,
    make_corpus,
    preprocess,
)
from mb_istft_vits_torch.config import Config
from mb_istft_vits_torch.data import TextAudioDataset
from mb_istft_vits_torch.utils import corpus

from torch_port_data import TINY_MODEL, write_tiny_dataset
from tests.torch_port_common import japply, make_weights, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import preprocess as jax_preprocess  # noqa: E402
import scripts.eval_checkpoint as jax_eval_checkpoint  # noqa: E402
import scripts.eval_metrics as jax_eval_metrics  # noqa: E402
import scripts.make_corpus as jax_make_corpus  # noqa: E402


def _run_jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    module.main()


def _close(ours, ref, rel):
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, float):
            assert abs(ours[k] - v) <= rel * max(abs(v), 1.0), (k, ours[k], v)
        else:
            assert ours[k] == v, k


# -- eval_metrics ----------------------------------------------------------------


def test_eval_metrics_matches_the_jax_script(tmp_path, monkeypatch):
    rng = np.random.RandomState(7)
    ref_dir, test_dir = tmp_path / "ref", tmp_path / "test"
    ref_dir.mkdir(), test_dir.mkdir()
    for i, n in enumerate((3000, 9000)):  # the F0 scores need >= 4096
        tone = np.sin(2 * np.pi * 140 * np.arange(n) / 16000)
        clean = (8000 * tone + 300 * rng.randn(n)).astype(np.int16)
        noisy = (clean + 900 * rng.randn(n)).astype(np.int16)
        wavfile.write(str(ref_dir / f"{i}.wav"), 16000, clean)
        wavfile.write(str(test_dir / f"{i}.wav"), 16000, noisy)
    a, b = str(ref_dir / "1.wav"), str(test_dir / "1.wav")
    _close(eval_metrics.pair_metrics(a, b),
           jax_eval_metrics._pair_metrics(a, b), 1e-4)
    ours, ref = tmp_path / "ours.json", tmp_path / "ref.json"
    assert eval_metrics.main([str(ref_dir), str(test_dir), "--json",
                              str(ours)]) == 0
    _run_jax_main(jax_eval_metrics, [str(ref_dir), str(test_dir), "--json",
                                     str(ref)], monkeypatch)
    got, want = json.loads(ours.read_text()), json.loads(ref.read_text())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


# -- eval_checkpoint ---------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny flagship config on 6 seeded wavs, its weights as a `.pth`
    and as the JAX tree."""
    root = tmp_path_factory.mktemp("ckpt")
    cfg_path = write_tiny_dataset(str(root))
    params, _ = make_weights(root, Config.from_json(cfg_path).model,
                             JConfig.from_json(cfg_path).model)
    return cfg_path, str(root / "G_0.pth"), params


@pytest.fixture(scope="module")
def eval_runs(checkpoint, tmp_path_factory):
    """The JSON of the port's eval_checkpoint and of the JAX script (its
    Orbax loader handed the JAX tree of the same weights), on 2
    utterances with --tts --bands; the port's saved wavs."""
    cfg_path, pth, params = checkpoint
    root = tmp_path_factory.mktemp("eval")
    args = ["-c", cfg_path, "-k", pth, "-n", "2", "--tts", "--bands"]
    assert eval_checkpoint.main(args + ["--out", str(root / "ours.json"),
                                        "--device", "cpu", "--save-audio",
                                        str(root / "wavs")]) == 0
    import mb_istft_vits_tpu.train.checkpoint as jckpt

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jckpt, "load_generator_params", lambda path: params)
        _run_jax_main(jax_eval_checkpoint,
                      args + ["--out", str(root / "ref.json")], mp)
    return (json.loads((root / "ours.json").read_text()),
            json.loads((root / "ref.json").read_text()), root / "wavs")


def test_eval_checkpoint_json_matches_the_jax_script(eval_runs):
    got, want, wavs = eval_runs
    assert sorted(got) == sorted(want) == ["rows", "summary"]
    assert sorted(got["summary"]) == sorted(want["summary"])
    for name in ("mcd", "lsd", "f0_rmse_hz", "vde", "mcd_tts_dtw",
                 "dur_ratio_tts"):
        assert sorted(got["summary"][name]) == sorted(want["summary"][name])
    assert sorted(got["summary"]["lsd_bands"]) \
        == sorted(want["summary"]["lsd_bands"])
    assert got["summary"]["n_utts"] == want["summary"]["n_utts"] == 2
    assert [sorted(r) for r in got["rows"]] \
        == [sorted(r) for r in want["rows"]]
    assert all(np.isfinite(v) for r in got["rows"] for v in r.values())
    assert sorted(os.listdir(wavs)) == sorted(
        f"utt{i}_{k}.wav" for i in range(2) for k in ("gt", "copy", "tts"))


def _jax_draws(params, cfg_j, spec_pad, f, x_pad, n_x, i, max_frames):
    """JAX's draws of utterance i in the script: the posterior noise of
    the copy synthesis (PRNGKey(i)) and the prior noise of the TTS decode
    (PRNGKey(1000 + i)), recovered from the latents."""
    synth = JSynthesizer(cfg_j)

    def posterior(m, y, yl):
        z, m_q, logs_q, y_mask = m.enc_q(y, yl, g=None,
                                         noise_rng=m.make_rng("noise"))
        return z, m_q, logs_q, y_mask

    z, m_q, logs_q, y_mask = japply(
        synth, params, spec_pad, np.asarray([f], np.int32), method=posterior,
        rngs={"noise": jax.random.PRNGKey(i)})
    post = np.where(y_mask > 0, (z - m_q) / np.exp(logs_q), 0.0)
    out = japply(synth, params, x_pad, np.asarray([n_x], np.int32),
                 method=JSynthesizer.infer, max_frames=max_frames,
                 rngs={"noise": jax.random.PRNGKey(1000 + i)})
    _, z_p, m_p, logs_p = out.latents
    prior = (np.asarray(z_p) - np.asarray(m_p)) / np.exp(np.asarray(logs_p))
    return post.astype(np.float32), prior.astype(np.float32)


def test_eval_checkpoint_scores_match_jax_with_its_draws(checkpoint,
                                                        eval_runs):
    """`score_utterance` with JAX's draws injected against the rows of
    the JAX script."""
    cfg_path, pth, params = checkpoint
    want = eval_runs[1]
    from mb_istft_vits_torch.dsp.stft import spectrogram
    from mb_istft_vits_torch.models import Synthesizer
    from mb_istft_vits_torch.weights import load_generator_pth

    cfg, cfg_j = Config.from_json(cfg_path), JConfig.from_json(cfg_path)
    d = cfg.data
    net_g = Synthesizer(cfg.model)
    net_g.load_state_dict(load_generator_pth(pth))
    net_g.eval()
    ds = TextAudioDataset(d.validation_files, d, device_spec=True)
    longest = max(len(ds[i]["wav"]) for i in range(2))
    max_frames = ((longest // d.hop_length) * 3 // 2 // 256 + 1) * 256
    for i, ref_row in enumerate(want["rows"]):
        item = ds[i]
        spec = spectrogram(torch.from_numpy(item["wav"][None]), 1024, 256,
                           1024).transpose(1, 2).numpy()
        f = spec.shape[1]
        spec_pad = np.pad(spec, ((0, 0), (0, -(-f // 64) * 64 - f), (0, 0)))
        x_pad = np.zeros((1, -(-len(item["x"]) // 64) * 64), np.int32)
        x_pad[0, :len(item["x"])] = item["x"]
        post, prior = _jax_draws(params, cfg_j.model, spec_pad, f, x_pad,
                                 len(item["x"]), i, max_frames)
        row, _ = eval_checkpoint.score_utterance(
            net_g, item, i, d, False, bands=True, tts_max_frames=max_frames,
            posterior_eps=t(post), tts_eps=t(prior))
        _close(row, ref_row, 1e-2)


# -- the corpus renderer and make_corpus --------------------------------------------


@pytest.mark.parametrize("sid", [0, 5, 11])
def test_corpus_render_is_bit_exact(sid, monkeypatch):
    en = "ðə kwˈɪk bɹˈaʊn fˈɑːks, dʒˈʌmps ˌoʊvɚ ðə lˈeɪzi dˈɑːɡ."
    jp = "[ a ] ch a N t o h a i Q t e n a i N d a sp [ a: ] <cough> ky o:"
    f0, fs = corpus._speaker_profile(sid)
    assert (f0, fs) == jax_make_corpus._speaker_profile(sid)
    monkeypatch.setattr(jax_make_corpus, "SR", 22050)
    ours = corpus.render(en, f"{sid}_a.wav", f0, fs)
    np.testing.assert_array_equal(
        ours, jax_make_corpus.render(en, f"{sid}_a.wav", f0, fs))
    assert corpus.rendered_samples(en, f"{sid}_a.wav") == ours.size
    monkeypatch.setattr(jax_make_corpus, "SR", 16000)
    ours = corpus.render(jp, f"{sid}_b.wav", f0, fs, corpus._plan_jp,
                         sr=16000)
    np.testing.assert_array_equal(
        ours, jax_make_corpus.render(jp, f"{sid}_b.wav", f0, fs,
                                     jax_make_corpus._plan_jp))
    assert corpus.rendered_samples(jp, f"{sid}_b.wav", corpus._plan_jp,
                                   sr=16000) == ours.size


def test_make_corpus_matches_the_jax_script(tmp_path, monkeypatch):
    argv = ["--dataset", "uudb", "--n-train", "3", "--n-val", "3"]
    assert make_corpus.main([str(tmp_path / "ours"), *argv]) == 0
    monkeypatch.setattr(jax_make_corpus, "SR", 22050)
    _run_jax_main(jax_make_corpus, [str(tmp_path / "ref"), *argv],
                  monkeypatch)
    for sub in ("wavs", "."):
        names = sorted(n for n in os.listdir(tmp_path / "ref" / sub)
                       if n.endswith((".wav", ".txt")))
        assert names == sorted(n for n in os.listdir(tmp_path / "ours" / sub)
                               if n.endswith((".wav", ".txt")))
        for n in names:
            ours = (tmp_path / "ours" / sub / n).read_bytes()
            ref = (tmp_path / "ref" / sub / n).read_bytes()
            if n.endswith(".txt"):
                ours, ref = (b.replace(str(tmp_path / k).encode(), b"")
                             for b, k in ((ours, "ours"), (ref, "ref")))
            assert ours == ref, n


def test_eval_vc_runs_a_tiny_twelve_speaker_model(tmp_path, capsys):
    make_corpus.main([str(tmp_path), "--dataset", "uudb", "--n-train", "1",
                      "--n-val", "12"])
    with open(tmp_path / "config.json") as f:
        cfg = json.load(f)
    cfg["model"].update(TINY_MODEL, gin_channels=8)
    path = str(tmp_path / "tiny.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    from mb_istft_vits_torch.models import Synthesizer

    torch.manual_seed(0)
    torch.save({"model": Synthesizer(Config.from_json(path).model)
                .state_dict()}, str(tmp_path / "G_0.pth"))
    assert eval_vc.main(["-c", path, "-k", str(tmp_path / "G_0.pth"),
                         "--pairs", "0:5", "3:7", "--out-dir",
                         str(tmp_path / "vc"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "/2 conversions track the target speaker" in out
    rows = [line for line in out.splitlines()
            if re.match(r"\s*\d+->\d+\s+\|", line)]
    assert len(rows) == 2 and all("nan" not in r for r in rows)
    assert sorted(os.listdir(tmp_path / "vc")) == ["vc_0_to_5.wav",
                                                   "vc_3_to_7.wav"]


# -- preprocess -----------------------------------------------------------------------


@pytest.mark.parametrize("language", ["en", "jp"])
def test_preprocess_is_byte_equal_to_the_jax_script(language, tmp_path,
                                                    monkeypatch):
    if language == "en":
        with open(os.path.join(REPO, "filelists",
                               "ljs_audio_text_test_filelist.txt"),
                  encoding="utf-8") as f:
            lines = f.readlines()[:20]
        flags = ["--text_cleaners", "basic_cleaners"]
    else:
        with open(os.path.join(REPO, "filelists",
                               "uudb_audio_sid_text_test_filelist.txt"),
                  encoding="utf-8") as f:
            lines = f.readlines()[:10]
        lines += ["a.wav|3|コンニチハ\n", "b.wav|4|アリガトウゴザイマシタ\n",
                  "short.wav\n"]  # an under-columned row: dropped by both
        flags = ["--text_index", "2", "--text_module", "text_JP",
                 "--text_cleaners", "japanese_cleaners"]
    for who in ("ours", "ref"):
        (tmp_path / who).mkdir()
        (tmp_path / who / "list.txt").write_text("".join(lines),
                                                 encoding="utf-8")
    assert preprocess.main(["--filelists", str(tmp_path / "ours" /
                                               "list.txt"), *flags]) == 0
    _run_jax_main(jax_preprocess, ["--filelists",
                                   str(tmp_path / "ref" / "list.txt"),
                                   *flags], monkeypatch)
    ours = (tmp_path / "ours" / "list.txt.cleaned").read_bytes()
    assert ours == (tmp_path / "ref" / "list.txt.cleaned").read_bytes()
    assert len(ours.splitlines()) >= 10
