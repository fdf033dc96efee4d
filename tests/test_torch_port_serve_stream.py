"""The PyTorch port's serving layer on the CPU, where it needs no JAX
reference: seeds, caches, warm-up, degenerate texts, the micro-batcher,
the incremental streaming engine, the streaming resamplers and the three
synthesis CLIs. The resamplers are held against the JAX package's
(`dsp/resample.py`), the one thing this file imports from it.

The model is the flagship config at the tiny width of torch_port_data.py,
random weights from a seed, buckets shrunk to (32, 64) / (64, 128, 256)
as in tests/test_infer.py.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import wave

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mb_istft_vits_torch.dsp import resample as port_rs
from mb_istft_vits_torch.infer.synthesis import SynthesisModule
from mb_istft_vits_torch.serve import IncrementalTTS, MicroBatcher, TTSRequest
from mb_istft_vits_torch.serve.streaming import StreamResampler
from mb_istft_vits_torch.utils import observability as obs
from torch_port_data import MS_CONFIG, write_tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = "ðə kwˈɪk bɹˈaʊn fˈɑːks, dʒˈʌmps ˌoʊvɚ ðə lˈeɪzi dˈɑːɡ."
SHORT = ["həlˈoʊ wˈɜːld.", "ðə kwˈɪk bɹˈaʊn.", "ɪts ɐ tˈɛst.",
         "θæŋk jˈuː."]


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    return write_tiny_config(str(tmp_path_factory.mktemp("cfg")))


@pytest.fixture(scope="module")
def module(tiny_config):
    m = SynthesisModule(tiny_config, seed=3, device="cpu")
    m.TEXT_BUCKETS = (32, 64)
    m.FRAME_BUCKETS = (64, 128, 256)
    return m


def _wait(cond, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


# -- SynthesisModule ----------------------------------------------------------


def test_same_seed_same_audio_after_other_calls(module):
    """A seed reseeds the noise on every call, whatever ran between."""
    a1, t1 = module.synthesize(TEXT, seed=42)
    module.synthesize(SHORT[0])  # unseeded: draws from the module's stream
    module.synthesize_batch(SHORT, seed=1)
    module.synthesize(TEXT, seed=7)
    a2, t2 = module.synthesize(TEXT, seed=42)
    assert t1["frame_bucket"] == t2["frame_bucket"]
    np.testing.assert_array_equal(a1, a2)
    a3, _ = module.synthesize(TEXT, seed=43)
    assert not np.array_equal(a1, a3)


def test_unseeded_calls_draw_fresh_noise(module):
    a1, t1 = module.synthesize(TEXT)
    a2, t2 = module.synthesize(TEXT)
    assert t1["frame_bucket"] == t2["frame_bucket"]
    assert not np.array_equal(a1, a2)


def test_audio_is_float32_on_the_int16_grid(module):
    audio, t = module.synthesize(TEXT, seed=0)
    assert audio.dtype == np.float32 and audio.ndim == 1
    assert len(audio) % module.hop_length == 0 and len(audio) > 0
    pcm = audio * 32767.0
    np.testing.assert_array_equal(pcm, np.round(pcm))
    assert np.abs(audio).max() <= 1.0
    for k in ("frontend", "dispatch", "sync"):
        assert t[k] >= 0.0
    assert t["dispatch"] + t["sync"] <= t["total"] + 1e-6
    assert t["audio_seconds"] == pytest.approx(len(audio) / 22050)


def test_serving_caches_hit(module):
    ids = module.text_to_ids(TEXT)
    assert ids is module.text_to_ids(TEXT)
    assert not ids.flags.writeable
    x1, l1 = module._pad_ids_cached(ids)
    x2, l2 = module._pad_ids_cached(module.text_to_ids(TEXT))
    assert x1 is x2 and l1 is l2
    # beyond the largest text bucket: the next multiple of 64
    assert len(ids) > 64 and x1.shape == (1, 128)
    assert int(l1[0]) == len(ids)


def test_raw_japanese_text_is_not_ported(module, monkeypatch):
    """Uncleaned text of a Japanese config runs the config's cleaner,
    `japanese_cleaners` (katakana in, phonemes out), where it used to
    raise; the JAX package's pyopenjtalk route for raw kanji is not
    carried by the port."""
    import dataclasses

    monkeypatch.setattr(module, "data_cfg", dataclasses.replace(
        module.data_cfg, text_module="text_JP",
        text_cleaners=("japanese_cleaners",)))
    ids = module.text_to_ids("コンニチハ", cleaned=False)
    want = module.text_to_ids("k o N n i t i h a", cleaned=True)
    np.testing.assert_array_equal(ids, want)
    assert len(want) == 2 * 9 + 1  # nine phonemes, blanks interspersed


def test_warmup_runs_each_bucket_pair(module, monkeypatch):
    seen = []
    infer = module._infer

    def spy(x, x_lengths, sid, ns, ls, nsw, max_frames, gen, w_eps,
            out_sr=None):
        seen.append((x.shape[1], max_frames))
        return infer(x, x_lengths, sid, ns, ls, nsw, max_frames, gen, w_eps,
                     out_sr)

    monkeypatch.setattr(module, "_infer", spy)
    module.warmup(pairs=[(32, 64), (64, 128)])
    assert seen == [(32, 64), (64, 128)]
    seen.clear()
    module.warmup()  # default: each text bucket with its frame bucket
    assert [tb for tb, _ in seen] == list(module.TEXT_BUCKETS)
    assert all(fb in module.FRAME_BUCKETS for _, fb in seen)


@pytest.mark.parametrize("text", ["", "   ", "a"])
def test_empty_and_one_token_text(module, text):
    audio, t = module.synthesize(text, seed=0)
    assert len(audio) > 0 and np.all(np.isfinite(audio))
    assert len(audio) % module.hop_length == 0


def test_frame_bucket_grows_when_the_decode_fills_it(module):
    """A decode with y_len == bucket is redone at 1.5x the bucket."""
    module._frames_per_token, module._ratio_observed = 0.01, True
    audio, t = module.synthesize(TEXT, seed=0)
    y_len = len(audio) // module.hop_length
    assert t["frame_bucket"] > max(y_len, 64)  # grew past the estimate


def _spans(log, name):
    return [(s, e) for n, _, s, e in log.spans(0, 1 << 62)[0] if n == name]


def test_a_redo_at_a_larger_bucket_is_a_retry_span(module, monkeypatch):
    """Under a profiler each redo is one `synth.retry` span holding its
    own `synth.dispatch`; the dispatch spans are the `dispatch` timing."""
    log = obs.SpanLog()
    monkeypatch.setattr(obs, "SPANS", log)
    module._frames_per_token, module._ratio_observed = 0.01, True
    with profile(activities=[ProfilerActivity.CPU]):
        _, t = module.synthesize(TEXT, seed=0)
    retries, dispatches = (_spans(log, "synth.retry"),
                           _spans(log, "synth.dispatch"))
    assert len(retries) >= 1 and len(dispatches) == len(retries) + 1
    for rs, re in retries:
        assert sum(rs <= s and e <= re for s, e in dispatches) == 1
    held = sum(e - s for s, e in dispatches) / 1e9
    assert abs(held - t["dispatch"]) < 1e-3 * len(dispatches)


# -- MicroBatcher -----------------------------------------------------------


def test_microbatcher_coalesces_concurrent_calls(module):
    with MicroBatcher(module, max_batch=4, max_wait_ms=200.0) as mb:
        results = {}
        gate = threading.Barrier(len(SHORT))

        def call(i):
            gate.wait()
            results[i] = mb.synthesize(SHORT[i], seed=7)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(SHORT))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert len(results) == len(SHORT)
        batched = {t["batched"] for _, t in results.values()}
        assert max(batched) >= 2, batched
        some = next(t for _, t in results.values() if t["batched"] >= 2)
        ref, _ = module.synthesize_batch(some["batch_order"], seed=7)
        for i, (audio, t) in results.items():
            if t["batched"] >= 2 and SHORT[i] in some["batch_order"]:
                j = some["batch_order"].index(SHORT[i])
                np.testing.assert_array_equal(audio, ref[j])
        a1, t1 = mb.synthesize(SHORT[0], seed=9)
        assert t1["batched"] == 1 and len(a1) > 0


class _EchoModule:
    """Instant stand-in for the module: a text's audio encodes the text."""

    @staticmethod
    def _audio(text):
        return np.array([ord(ch) for ch in text], np.float32)

    def synthesize(self, text, sid=None, **kwargs):
        return self._audio(text), {}

    def synthesize_batch(self, texts, sids=None, **kwargs):
        return [self._audio(t) for t in texts], {}


def test_microbatcher_stress_every_caller_gets_its_own_row():
    """More callers than cores, the interpreter switching threads every
    microsecond: each caller still gets its own text's row."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        texts = [f"t{i}" * (1 + i % 5) for i in range(4 * (os.cpu_count()
                                                            or 4))]
        results = {}
        with MicroBatcher(_EchoModule(), max_batch=8, max_wait_ms=0.5) as mb:
            def call(i):
                results[i] = mb.synthesize(texts[i], seed=i % 2)

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(len(texts))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert sorted(results) == list(range(len(texts)))
    for i, (audio, t) in results.items():
        np.testing.assert_array_equal(audio, _EchoModule._audio(texts[i]))
        assert 1 <= t["batched"] <= 8


def test_microbatcher_surfaces_errors(module, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("decode failed")

    monkeypatch.setattr(module, "synthesize", boom)
    with MicroBatcher(module, max_batch=4, max_wait_ms=1.0) as mb:
        with pytest.raises(RuntimeError, match="decode failed"):
            mb.synthesize(SHORT[0])


@pytest.mark.parametrize("backend", ["echo", "tiny"])
def test_microbatcher_spans_each_queue_wait_and_each_decode(
        backend, request, monkeypatch):
    """Under a profiler, N concurrent requests give N `serve.queued`
    spans, each ending where a `serve.decode` starts, one decode span a
    group and a `serve.coalesce` span before each; a coalesced decode's
    probe and dispatch spans lie inside its decode span, and its timings
    still carry no `dispatch`."""
    target = (_EchoModule() if backend == "echo"
              else request.getfixturevalue("module"))
    log = obs.SpanLog()
    monkeypatch.setattr(obs, "SPANS", log)
    results = {}
    gate = threading.Barrier(len(SHORT))
    with profile(activities=[ProfilerActivity.CPU]):
        with MicroBatcher(target, max_batch=4, max_wait_ms=200.0) as mb:
            def call(i):
                gate.wait()
                results[i] = mb.synthesize(SHORT[i], seed=7)

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(len(SHORT))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in threads)
        # the worker has stopped, so its last decode span is recorded
    assert sorted(results) == list(range(len(SHORT)))
    groups = {id(t): t for _, t in results.values()}
    queued, decodes = _spans(log, "serve.queued"), _spans(log,
                                                          "serve.decode")
    assert len(queued) == len(SHORT)
    assert len(decodes) == len(groups)
    starts = {s for s, _ in decodes}
    assert all(s <= e and e in starts for s, e in queued)
    assert len(_spans(log, "serve.coalesce")) >= len(groups)
    coalesced = [t for t in groups.values() if t["batched"] >= 2]
    assert coalesced and all("dispatch" not in t for t in coalesced)
    if backend == "tiny":
        for name in ("synth.probe", "synth.dispatch"):
            got = _spans(log, name)
            assert got and all(any(ds <= s and e <= de for ds, de in decodes)
                               for s, e in got)


# -- IncrementalTTS ---------------------------------------------------------


def test_incremental_tts_streams_the_whole_utterance(module):
    chunks = []
    engine = IncrementalTTS(module, on_chunk=lambda uid, p: chunks.append(
        (uid, p)), send_interval_ms=0, base64_encode=False)
    engine.start()
    z, y_len, _ = module.prepare_shared_latents(TEXT, noise_scale=0.0)
    engine.submit(TTSRequest(text=TEXT, utterance_id="u1", noise_scale=0.0))
    want = y_len * module.hop_length
    assert _wait(lambda: sum(len(p) // 2 for _, p in chunks) >= want)
    engine.stop()
    assert {uid for uid, _ in chunks} == {"u1"}
    pcm = np.concatenate([np.frombuffer(p, np.int16) for _, p in chunks])
    assert len(pcm) == want
    assert len(chunks) == -(-want // engine.chunk_samples)
    # the same latents streamed by hand, then quantized as the engine does
    streamed = np.concatenate(list(module.stream_from_latents(z)))
    np.testing.assert_array_equal(
        pcm, np.round(np.clip(streamed, -1, 1) * 32767).astype(np.int16))


def test_incremental_tts_revoke(module):
    chunks = []
    engine = IncrementalTTS(module, on_chunk=lambda uid, p: chunks.append(
        uid), send_interval_ms=0, base64_encode=False)
    engine.revoke("dead")
    engine.start()
    engine.submit(TTSRequest(text=TEXT, utterance_id="dead"))
    engine.submit(TTSRequest(text=SHORT[0], utterance_id="live"))
    assert _wait(lambda: "live" in chunks)
    engine.stop()
    assert "dead" not in chunks


def test_stream_resampler_continuous():
    """The linear stream resampler's grid carries across chunks."""
    audio = np.random.RandomState(0).randn(22050).astype(np.float32)
    step = 22050 / 48000
    ts = np.arange(0.0, len(audio) - 1 + 1e-9, step)
    ref = np.interp(ts, np.arange(len(audio)), audio).astype(np.float32)
    for chunk in (160, 1000, 4096):
        rs = StreamResampler(22050, 48000)
        out = np.concatenate([rs(audio[i: i + chunk])
                              for i in range(0, len(audio), chunk)])
        assert len(out) == len(ref)
        np.testing.assert_allclose(out, ref, atol=1e-6)


# -- resamplers against the JAX package ------------------------------------


@pytest.mark.parametrize("sr_out", [16000, 48000])
@pytest.mark.parametrize("path", ["numpy", "torch"])
def test_resample_matches_jax(path, sr_out):
    from mb_istft_vits_tpu.dsp import resample as jax_rs

    x = np.random.RandomState(1).randn(2, 3000, 2).astype(np.float32)
    if path == "numpy":
        for b in range(2):
            got = port_rs.resample_poly(x[b, :, 0], 22050, sr_out)
            want = jax_rs.resample_poly(x[b, :, 0], 22050, sr_out)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        got = port_rs.resample_poly_torch(torch.from_numpy(x), 22050,
                                          sr_out).numpy()
        want = np.asarray(jax_rs.resample_poly_jax(x, 22050, sr_out))
        assert got.shape == want.shape == (2, -(-3000 * sr_out // 22050), 2)
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("sr_out", [16000, 48000])
def test_polyphase_stream_resampler_equals_offline(sr_out):
    x = np.random.RandomState(2).randn(9001)
    want = port_rs.resample_poly(x, 22050, sr_out)
    for chunk in (37, 1000, 4096):
        rs = port_rs.PolyphaseStreamResampler(22050, sr_out)
        got = np.concatenate([rs(x[i: i + chunk])
                              for i in range(0, len(x), chunk)]
                             + [rs.flush()])
        assert len(got) == len(want)
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_synthesize_batch_out_sample_rate(module):
    """Resampling on the device: trimmed lengths scale with the rational
    ratio (ceil), and rows match a host resample of the model-rate rows
    away from the trim point."""
    base, _ = module.synthesize_batch(SHORT[:2], seed=5)
    res, t = module.synthesize_batch(SHORT[:2], seed=5,
                                     out_sample_rate=16000)
    assert t["audio_seconds"] == pytest.approx(
        sum(len(a) for a in res) / 16000)
    for a0, a1 in zip(base, res):
        assert len(a1) == -(-len(a0) * 16000 // 22050)
        want = port_rs.resample_poly(a0, 22050, 16000)
        np.testing.assert_allclose(a1[:-64], want[:-64], atol=5e-4)


# -- CLIs -------------------------------------------------------------------


def _wav(path):
    with wave.open(str(path)) as w:
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()),
                                               np.int16)


def test_synthesize_cli_flags(tiny_config, tmp_path, capsys):
    from mb_istft_vits_torch.synthesize import main

    out = tmp_path / "a.wav"
    main(["-c", tiny_config, "-t", SHORT[0], "-o", str(out), "--device",
          "cpu", "--sid", "0", "--noise-scale-w", "0.5", "--print-base64"])
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[-1])
    assert lines[0].startswith("audio: ") and "Real Time Factor" in lines[0]
    assert lines[1].startswith("Base64 encoded data (first 80 chars): ")
    sr, pcm = _wav(out)
    assert sr == 22050 and len(pcm) == report["samples"] > 0
    floats = np.frombuffer(__import__("base64").b64decode(lines[2]),
                           np.float32)
    np.testing.assert_array_equal(np.round(floats * 32767).astype(np.int16),
                                  pcm)


def test_synthesize_z_cli(tiny_config, tmp_path, capsys):
    from mb_istft_vits_torch.synthesize_z import main

    main(["-c", tiny_config, "-t", SHORT[1], "-o", str(tmp_path),
          "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    lens = [len(_wav(tmp_path / f)[1])
            for f in ("output_normal.wav", "output_z.wav")]
    assert lens[0] == lens[1] == report["frames"] * 256 > 0


def test_batch_synthesize_cli(tiny_config, tmp_path, capsys):
    from mb_istft_vits_torch.batch_synthesize import main, read_filelist

    fl = tmp_path / "list.txt"
    fl.write_text("a/x.wav|" + SHORT[0] + "\nb/x.wav|0|" + SHORT[1]
                  + "\nno separator\n\ny|" + SHORT[2] + "\n",
                  encoding="utf-8")
    rows = read_filelist(str(fl))
    assert rows == [("a/x.wav", None, SHORT[0]), ("b/x.wav", 0, SHORT[1]),
                    ("y", None, SHORT[2])]
    out = tmp_path / "out"
    main(["-c", tiny_config, "-f", str(fl), "-o", str(out), "--batch", "2",
          "--out-sample-rate", "16000", "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["x.wav", "x_2.wav", "y.wav"]
    for name in os.listdir(out):
        sr, pcm = _wav(out / name)
        assert sr == 16000 and len(pcm) > 0
    assert "done: 3 utterances" in capsys.readouterr().out


def test_voice_conversion_cli(tmp_path, capsys):
    """`python -m mb_istft_vits_torch.voice_conversion` on the Japanese
    multi-speaker config shrunk: a synthesized utterance of speaker 0,
    re-spoken as speaker 5, keeps its length and changes; a wav at another
    rate is refused."""
    from mb_istft_vits_torch.utils.audio import write_wav
    from mb_istft_vits_torch.voice_conversion import main

    cfg = write_tiny_config(str(tmp_path), MS_CONFIG)
    sm = SynthesisModule(cfg, seed=0, device="cpu")
    audio, _ = sm.synthesize("k o N n i t i w a", 0, seed=1)
    src, out = tmp_path / "src.wav", tmp_path / "out.wav"
    write_wav(str(src), audio, 16000)
    assert main(["-c", cfg, "-i", str(src), "--sid-src", "0", "--sid-tgt",
                 "5", "-o", str(out), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith(f"wrote {out}")
    sr, pcm = _wav(out)
    _, pcm_src = _wav(src)
    assert sr == 16000 and len(pcm) == len(pcm_src) > 0
    assert not np.array_equal(pcm, pcm_src)
    write_wav(str(src), audio, 22050)
    with pytest.raises(SystemExit, match="16000"):
        main(["-c", cfg, "-i", str(src), "--sid-src", "0", "--sid-tgt", "5",
              "-o", str(out), "--device", "cpu"])


@pytest.mark.parametrize("cli", ["synthesize", "synthesize_z",
                                 "batch_synthesize", "voice_conversion"])
def test_cli_without_a_card_exits(tiny_config, tmp_path, cli):
    """Without --device cpu a CLI wants CUDA and, with no card, exits
    non-zero before writing anything."""
    fl = tmp_path / "list.txt"
    fl.write_text("x|" + SHORT[0] + "\n", encoding="utf-8")
    args = {"synthesize": ["-t", SHORT[0], "-o", str(tmp_path / "a.wav")],
            "synthesize_z": ["-t", SHORT[0], "-o", str(tmp_path)],
            "batch_synthesize": ["-f", str(fl), "-o", str(tmp_path / "o")],
            "voice_conversion": ["-i", str(fl), "--sid-src", "0",
                                 "--sid-tgt", "1", "-o",
                                 str(tmp_path / "v.wav")]}
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, "-m", f"mb_istft_vits_torch.{cli}", "-c",
         tiny_config] + args[cli], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not list(tmp_path.glob("*.wav"))
