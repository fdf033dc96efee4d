"""VITS itself on the port (port only, no JAX): a config with no iSTFT flag
builds VITS's HiFi-GAN decoder, and the port is held to the benchmark's
plain reference of VITS (`perfbench/reference/vits_hifigan.py`, written
from the published code) on seeded random weights at a small size: the
generator with and without a speaker, `Synthesizer.infer` with the
stochastic duration predictor and speakers, `synthesize_batch` over mixed
speakers against one reference call a row. A state dict with VITS's names
loads, the spectrogram-domain routes refuse the head while the PCM
chunked routes serve it, a training step of a tiny VITS config gives
finite losses and no sub-band term, and the serving module counts each
decode's frames only while a profiler runs.

Tolerances: float32 on the CPU, the same operations in another order:
1e-5 max-abs on a waveform of peak about 1e-2 (the reference's tanh
output) and 1e-4 relative L2; frame counts exact (the durations are
ceil'd sums that equal inputs give equally)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import profile

from mb_istft_vits_torch.config import Config
from mb_istft_vits_torch.models import Synthesizer
from mb_istft_vits_torch.models.decoders import HiFiGANGenerator
from mb_istft_vits_torch.utils import observability as obs
from perfbench.reference import vits_hifigan as ref
from perfbench.yardstick import corpus, weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VITS = os.path.join(ROOT, "perfbench", "configs", "vits_vctk.json")
SHIFT = {"dp.flows.0.m": [[0, 1, -0.4]], "dp.flows.0.logs": 0.0}

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(config path, config dict, port config, weights) of VITS at a small
    width: every published structure (HiFi-GAN [8, 8, 2, 2], three
    ResBlocks a stage, the SDP, 109 speakers), channels cut."""
    with open(VITS) as f:
        conf = json.load(f)
    conf["model"].update(hidden_channels=32, filter_channels=64,
                         inter_channels=32, upsample_initial_channel=32,
                         n_layers=2, gin_channels=16)
    path = str(tmp_path_factory.mktemp("vits") / "vits_tiny.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    cfg = Config.from_json(path)
    with torch.device("meta"):
        leaves = [(k, tuple(v.shape))
                  for k, v in Synthesizer(cfg.model).state_dict().items()]
    p = weights.make(leaves, 7, torch.device("cpu"),
                     cfg.model.hidden_channels, SHIFT)
    # a louder head, so the waveform is well above float32's rounding
    p["dec.conv_post.weight"] = p["dec.conv_post.weight"] * 8.0
    return path, conf, cfg, p


def _model(cfg, p):
    model = Synthesizer(cfg.model)
    model.load_state_dict(p)
    return model.eval()


def _m(conf, cfg):
    return dict(conf["model"], n_vocab=cfg.model.n_vocab)


def test_a_config_without_an_istft_flag_is_vits(tiny):
    _, _, cfg, _ = tiny
    assert cfg.model.decoder_kind == "hifigan"
    dec = Synthesizer(cfg.model).dec
    assert isinstance(dec, HiFiGANGenerator)
    assert dec.conv_pre.weight_norm is False and dec.conv_post.bias is None
    assert tuple(dec.cond.weight.shape) == (32, 16, 1)
    assert all(block.cond is None for block in dec.resblocks)
    for name, kind in (("ljs_mb_istft_vits.json", "mb_istft"),
                       ("ljs_istft_vits.json", "istft"),
                       ("uudb_ms_istft_vits_ms.json", "ms_istft")):
        got = Config.from_json(os.path.join(ROOT, "configs", name))
        assert got.model.decoder_kind == kind


def test_the_published_vctk_model_is_whole():
    """At its published widths: 109 speakers, the SDP, [8, 8, 2, 2] from
    512 channels, about 40 M parameters (meta tensors: nothing is
    allocated)."""
    cfg = Config.from_json(VITS)
    with torch.device("meta"):
        model = Synthesizer(cfg.model)
    assert cfg.model.use_sdp and cfg.model.n_speakers == 109
    assert tuple(model.emb_g.weight.shape) == (109, 256)
    assert [tuple(u.weight_v.shape) for u in model.dec.ups] == [
        (512, 256, 16), (256, 128, 16), (128, 64, 4), (64, 32, 4)]
    n = sum(p.numel() for p in model.parameters())
    assert 39e6 < n < 41e6, n


@pytest.mark.parametrize("speaker", [False, True])
def test_hifigan_generator_matches_the_reference(tiny, speaker):
    _, conf, cfg, p = tiny
    model = _model(cfg, p)
    gen = torch.Generator().manual_seed(1)
    z = torch.randn(2, cfg.model.inter_channels, 20, generator=gen)
    g = (p["emb_g.weight"][torch.tensor([3, 108])][:, :, None] if speaker
         else None)
    with torch.no_grad():
        ours, o_mb, spec, phase = model.dec(z, g)
        theirs = ref.generator(p, _m(conf, cfg), z, g)
    assert o_mb is None and spec is None and phase is None
    assert ours.shape == (2, 1, 20 * 256)
    assert theirs.abs().max() > 1e-2
    torch.testing.assert_close(ours, theirs, rtol=0, atol=1e-5)


def _ids(n, t, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(1, 100, (n, t), generator=gen)


def test_infer_with_the_sdp_and_speakers_matches_the_reference(tiny):
    _, conf, cfg, p = tiny
    model, m = _model(cfg, p), _m(conf, cfg)
    x, xl = _ids(3, 24, 2), torch.tensor([24, 17, 9])
    sid = torch.tensor([5, 108, 0])
    gen = torch.Generator().manual_seed(3)
    w_eps = torch.randn(3, 24, 2, generator=gen)
    frames = 192
    eps = torch.randn(3, cfg.model.inter_channels, frames, generator=gen)
    with torch.no_grad():
        out = model.infer(x, xl, sid, 0.667, 1.0, 0.8, frames,
                          eps=eps.transpose(1, 2), w_eps=w_eps)
        o, y_len = ref.infer(p, m, x, xl, sid, eps, w_eps.transpose(1, 2),
                             frames)
        pred = ref.predicted_frames(p, m, x, xl, sid,
                                    w_eps.transpose(1, 2))
    assert out.y_lengths.tolist() == y_len.tolist()
    assert (pred.clamp(max=frames) == y_len).all()
    assert out.spec is None and out.phase is None and out.o_mb is None
    ours = out.o[..., 0]
    for row in range(3):
        n = int(y_len[row]) * 256
        a, b = ours[row, :n], o[row, :n]
        assert float((a - b).norm() / b.norm()) < 1e-4, row


def test_synthesize_batch_of_mixed_speakers_matches_one_reference_call_a_row(
        tiny):
    """Three texts in three voices as one batch (the micro-batcher's
    coalesced path); each row against the reference on its own, with the
    module's draws: w_eps at [batch bucket, text bucket, 2], then the
    prior's noise at [batch bucket, channels, frame bucket]."""
    from mb_istft_vits_torch.infer.synthesis import SynthesisModule

    path, conf, cfg, p = tiny
    module = SynthesisModule(path, params=p, device="cpu")
    table = corpus.symbols("text")
    with open(os.path.join(ROOT, "perfbench", "corpus", "vctk_test.txt"),
              encoding="utf-8") as f:
        lines = [line.rstrip("\n").split("|", 1) for line in f][:3]
    texts, sids = [t for _, t in lines], [int(s) for s, _ in lines]
    assert len(set(sids)) == 3
    audios, _ = module.synthesize_batch(texts, sids=sids, seed=0)
    ids = [corpus.text_ids(t, table, False) for t in texts]
    nb = module._batch_bucket(3)
    t_x = max(len(i) for i in ids)
    t_b = next(b for b in module.TEXT_BUCKETS if b >= t_x)
    gen = torch.Generator().manual_seed(0)
    w_eps = torch.randn((nb, t_b, 2), generator=gen).transpose(1, 2)
    m = _m(conf, cfg)
    rows = ids + [np.zeros(1, np.int64)] * (nb - 3)
    x = torch.zeros(nb, t_b, dtype=torch.long)
    for k, r in enumerate(rows):
        x[k, :len(r)] = torch.from_numpy(r)
    xl = torch.tensor([len(r) for r in rows])
    all_sids = torch.tensor(sids + [0] * (nb - 3))
    with torch.no_grad():
        pred = ref.predicted_frames(p, m, x, xl, all_sids, w_eps)
        bucket = next(b for b in module.FRAME_BUCKETS if b >= int(pred.max()))
        eps = torch.randn((nb, cfg.model.inter_channels, bucket),
                          generator=gen)
        for row in range(3):
            o, y_len = ref.infer(p, m, x[row:row + 1, :len(ids[row])],
                                 xl[row:row + 1], all_sids[row:row + 1],
                                 eps[row:row + 1],
                                 w_eps[row:row + 1, :, :len(ids[row])],
                                 bucket)
            n = int(y_len[0]) * 256
            assert len(audios[row]) == n
            want = np.round(np.clip(o[0, :n].numpy(), -1, 1) * 32767) / 32767
            gap = np.linalg.norm(audios[row] - want) / np.linalg.norm(want)
            assert gap < 1e-3, (row, gap)


def test_a_state_dict_with_vits_names_loads(tiny, tmp_path):
    """VITS's `G_*.pth` layout: plain `dec.conv_pre.weight`, `dec.cond.*`,
    `dec.conv_post.weight` with no bias, the SDP's affine as [2, 1]."""
    from mb_istft_vits_torch.weights import load_generator_pth

    _, _, cfg, p = tiny
    names = set(p)
    assert {"dec.conv_pre.weight", "dec.conv_pre.bias", "dec.cond.weight",
            "dec.cond.bias", "dec.conv_post.weight"} <= names
    assert "dec.conv_post.bias" not in names
    assert "dec.conv_pre.weight_v" not in names
    path = str(tmp_path / "G_0.pth")
    torch.save({"model": {k: v.clone() for k, v in p.items()},
                "iteration": 0, "learning_rate": 2e-4}, path)
    model = Synthesizer(cfg.model)
    model.load_state_dict(load_generator_pth(path), strict=True)
    assert torch.equal(model.dec.conv_post.weight, p["dec.conv_post.weight"])


def test_the_jax_bridge_refuses_the_hifigan_head(tiny):
    from mb_istft_vits_torch.weights import state_dict_from_jax

    with pytest.raises(ValueError, match="HiFi-GAN"):
        state_dict_from_jax({}, tiny[2].model)


@pytest.fixture(scope="module")
def module(tiny):
    from mb_istft_vits_torch.infer.synthesis import SynthesisModule

    path, _, _, p = tiny
    return SynthesisModule(path, params=p, device="cpu")


@pytest.mark.parametrize("route", ["decode_spec_join", "_decode_spec",
                                   "decode_spec_tail"])
def test_the_spectrogram_domain_routes_refuse_the_head(module, route):
    z = np.zeros((40, module.cfg.inter_channels), np.float32)
    with pytest.raises(ValueError, match="HiFi-GAN head"):
        if route == "decode_spec_join":
            module.decode_spec_join(z, sid=3)
        elif route == "_decode_spec":
            module._decode_spec(torch.from_numpy(z)[None], sid=3)
        else:
            spec = torch.zeros(1, 10, 9)
            module.model.decode_spec_tail(spec, spec)


def test_the_pcm_chunked_routes_serve_the_head(module):
    """The streaming engine's route (`stream_from_latents`) and the batched
    chunks join PCM windows, so the head serves them."""
    z, y_len, sid = module.prepare_shared_latents("hˈɛloʊ wˈɜːld.", 7)
    streamed = np.concatenate(list(module.stream_from_latents(z, sid)))
    batched = module.decode_chunks_batched(z, sid)
    assert len(streamed) == len(batched) == y_len * 256
    assert np.abs(streamed).max() > 0


def test_the_frames_counter_counts_each_decode_only_while_profiling(
        module, monkeypatch):
    monkeypatch.setattr(obs, "COUNTS", obs.SpanLog())
    texts = ["ðə kˈæt.", "ɐ lˈɑːŋɡɚ sˈɛntəns ðæn ðə fˈɜːst wˈʌn."]
    module.synthesize(texts[0], 3, seed=0)
    assert obs.recorded_counts(0, 1 << 62) == ([], 0)
    with profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        audio, t = module.synthesize(texts[0], 3, seed=0)
        audios, _ = module.synthesize_batch(texts, sids=[3, 40], seed=0)
    got, dropped = obs.recorded_counts(0, 1 << 62)
    assert dropped == 0 and [n for n, _, _ in got] == ["synth.frames"] * 2
    (rows, bucket, frames, ids), (b_rows, b_bucket, b_frames, b_ids) = (
        v for _, _, v in got)
    assert (rows, bucket) == (1, t["frame_bucket"])
    assert frames == (len(audio) // 256,)
    assert ids == (len(module.text_to_ids(texts[0])),)
    assert b_rows == 2 and b_bucket >= max(b_frames)
    assert b_frames == tuple(len(a) // 256 for a in audios)
    assert b_ids == tuple(len(module.text_to_ids(s)) for s in texts)


def test_one_training_step_of_a_tiny_vits(tiny):
    from mb_istft_vits_torch.train.step import (create_train_state,
                                                draw_step, train_step)

    path, _, cfg, _ = tiny
    import dataclasses
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, fp16_run=False, segment_size=4096))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, segment_size=16))
    state = create_train_state(cfg, torch.device("cpu"), seed=0)
    gen = torch.Generator().manual_seed(0)
    t_spec = 40
    batch = {
        "x": torch.randint(1, 100, (2, 30), generator=gen),
        "x_lengths": torch.tensor([30, 21]),
        "wav": (torch.randn(2, t_spec * 256 + 768, 1, generator=gen)
                * 3000).to(torch.int16),
        "spec_lengths": torch.tensor([40, 33]),
        "sid": torch.tensor([4, 99]),
    }
    metrics = train_step(state, batch, draw_step(state, batch))
    losses = {k: float(v) for k, v in metrics.items()
              if k.startswith("loss/")}
    assert all(np.isfinite(v) for v in losses.values()), losses
    for k in ("loss/g/gen", "loss/g/fm", "loss/g/mel", "loss/g/dur",
              "loss/g/kl", "loss/d/total"):
        assert losses[k] != 0.0, k
    assert losses["loss/g/subband"] == 0.0
    assert state.step == 1
