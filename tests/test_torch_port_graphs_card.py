"""The serving programs as CUDA graphs (`infer/graphs.py`) on a card, at
the tiny width of torch_port_data.py, seeded random weights, TF32 off.

Each replay is held bit for bit to a direct call of its body on the same
inputs (the flagship in float32 and bf16, the 12-speaker model with a
speaker id, the single-band iSTFT model); a knob change replays the same
graph; a new shape is captured once; a seeded request is the eager
path's; two mesh positions on one card (one replica, one graph) give the
single device's batch; a capture from the micro-batcher's worker thread;
0-dim knobs on the card give Python floats' bits in both dtypes; the
iSTFT is torch.istft's. Needs a CUDA device and skips without one;
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_graphs_card.py
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from mb_istft_vits_torch.infer import programs
from mb_istft_vits_torch.infer.synthesis import SynthesisModule
from torch_port_data import CONFIG, MS_CONFIG, write_tiny_config

TEXTS = ["ðə kwˈɪk bɹˈaʊn fˈɑːks, dʒˈʌmps ˌoʊvɚ ðə lˈeɪzi dˈɑːɡ.",
         "həlˈoʊ wˈɜːld.", "ðə kwˈɪk bɹˈaʊn."]
JP_TEXT = "k o N n i t i w a"
PAIRS = [(32, 64), (64, 128)]
ISTFT_CONFIG = CONFIG.replace("ljs_mb_istft_vits", "ljs_istft_vits")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return {name: write_tiny_config(str(tmp_path_factory.mktemp(name)), cfg)
            for name, cfg in (("flagship", CONFIG), ("ms", MS_CONFIG),
                              ("istft", ISTFT_CONFIG))}


def _module(path, dtype=torch.float32, **kw):
    sm = SynthesisModule(path, None, None, 0, dtype, device="cuda", **kw)
    sm.TEXT_BUCKETS = (32, 64)
    sm.FRAME_BUCKETS = (64, 128, 256)
    return sm


def _direct(sm, name, *args, **options):
    with torch.no_grad():
        return getattr(programs, name)(sm.model, *args, **options)


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return len(a) == len(b) and all(map(torch.equal, a, b))


VARIANTS = [("flagship", torch.float32, None), ("flagship", torch.bfloat16,
                                                None),
            ("ms", torch.float32, 5), ("istft", torch.float32, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS, ids=lambda v: f"{v[0]}-{v[1]}")
def test_replays_equal_direct_calls(paths, variant):
    name, dtype, speaker = variant
    sm = _module(paths[name], dtype)
    sm.warmup(PAIRS)
    captured = sm.graphs.captures
    assert captured == 2 * len(PAIRS)
    sid = None if speaker is None else sm._sid_rows(1, speaker)
    for tb, fb in PAIRS:
        x = torch.randint(1, sm.cfg.n_vocab, (1, tb), device="cuda")
        xl = torch.tensor([tb - 3], device="cuda")
        for knobs in ((0.667, 1.0, 0.8), (0.3, 1.2, 0.5)):
            gen = torch.Generator("cuda").manual_seed(1)
            eps = sm._eps(gen, 1, fb)
            ns, ls, nsw = (sm._knob(v, sm.device) for v in knobs)
            got = sm._infer(x, xl, sid, *knobs, fb, None, None, eps=eps)
            want = _direct(sm, "infer", x, xl, sid, ns, ls, nsw, eps, None,
                           max_frames=fb)
            assert _equal(got, want), (tb, fb, knobs)
            got = sm._predict_frames(x, xl, sid, knobs[1], knobs[2], None)
            assert _equal(got, _direct(sm, "probe", x, xl, sid, ls, nsw,
                                       None))
    # every call replayed the warmed graphs, whatever the knobs
    assert sm.graphs.captures == captured
    # a new shape is captured once
    z = torch.randn((2, 40, sm.cfg.inter_channels), device="cuda",
                    dtype=dtype)
    for _ in range(2):
        got = sm._decode_pcm(z, speaker)
    assert sm.graphs.captures == captured + 1
    assert _equal(got, _direct(sm, "decode_pcm", z,
                               sm._sid_rows(2, speaker)))
    spec = sm._decode_spec(z, speaker)
    assert _equal(spec, _direct(sm, "decode_spec", z,
                                sm._sid_rows(2, speaker)))
    assert sm.graphs.pool_bytes() > 0


@pytest.mark.cuda
def test_seeded_request_is_the_eager_path(paths):
    """synthesize(seed) on the graphs: the eager model methods' PCM at the
    same seed and bucket, and a repeat is bit-equal."""
    sm = _module(paths["flagship"])
    sm._frames_per_token, sm._ratio_observed = 3.0, False  # the probe
    audio, tm = sm.synthesize(TEXTS[0], seed=4)
    x, xl = sm._pad_ids(sm.text_to_ids(TEXTS[0]))
    gen = torch.Generator("cuda").manual_seed(4)
    with torch.no_grad():
        out = sm.model.infer(x, xl, None, 0.667, 1.0, 0.8,
                             tm["frame_bucket"], generator=gen)
    pcm = programs._pcm16(out.o)[0].cpu().numpy()
    want = pcm.astype(np.float32)[: audio.size] / 32767.0
    assert np.array_equal(audio, want)
    sm._frames_per_token, sm._ratio_observed = 3.0, False
    again, t2 = sm.synthesize(TEXTS[0], seed=4)
    assert t2["frame_bucket"] == tm["frame_bucket"]
    assert np.array_equal(again, audio)


@pytest.mark.cuda
def test_two_mesh_positions_share_a_graph(paths):
    """mesh=[cuda:0, cuda:0]: both halves of a batch replay one graph, and
    neither overwrites the other's output."""
    single = _module(paths["flagship"])
    mesh = _module(paths["flagship"], mesh=["cuda:0", "cuda:0"])
    a, _ = single.synthesize_batch(TEXTS, seed=7)
    b, _ = mesh.synthesize_batch(TEXTS, seed=7)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and np.abs(x - y).max() <= 5e-4
    z, _, _ = single.prepare_shared_latents(TEXTS[0], seed=3)
    kw = dict(chunk_frames=16, overlap_frames=4)
    x, y = single.decode_chunks_batched(z, **kw), mesh.decode_chunks_batched(
        z, **kw)
    assert x.shape == y.shape and np.abs(x - y).max() <= 5e-4
    infers = [k for k in mesh.graphs.keys() if k[0] == "infer"]
    assert len(infers) == 1


@pytest.mark.cuda
def test_capture_from_the_microbatch_worker(paths):
    from mb_istft_vits_torch.serve import MicroBatcher

    sm = _module(paths["ms"])
    results, gate = {}, threading.Barrier(4)

    def call(i):
        gate.wait()
        results[i] = mb.synthesize(JP_TEXT, i, seed=2)

    with MicroBatcher(sm, max_batch=4, max_wait_ms=50.0) as mb:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    assert len(results) == 4 and sm.graphs.captures > 0
    for audio, _ in results.values():
        assert audio.size > 0 and np.isfinite(audio).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_cuda_knobs_equal_python_floats(paths, dtype):
    sm = _module(paths["flagship"], dtype)
    x = torch.randint(1, sm.cfg.n_vocab, (1, 32), device="cuda")
    xl = torch.tensor([29], device="cuda")
    eps = sm._eps(torch.Generator("cuda").manual_seed(0), 1, 64)
    for knobs in ((0.667, 1.0, 0.8), (0.3, 1.3, 0.5)):
        tensors = [torch.tensor(v, device="cuda") for v in knobs]
        with torch.no_grad():
            a = sm.model.infer(x, xl, None, *knobs, 64, eps=eps)
            b = sm.model.infer(x, xl, None, *tensors, 64, eps=eps)
        assert torch.equal(a.o, b.o) and torch.equal(a.latents[0],
                                                     b.latents[0])


@pytest.mark.cuda
def test_istft_is_torch_istft_on_the_card():
    import importlib

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    stft = importlib.import_module("mb_istft_vits_torch.dsp.stft")
    gen = torch.Generator("cuda").manual_seed(0)
    for rows, frames in ((4, 1024), (1, 4096)):
        mag = torch.rand((rows, 9, frames), generator=gen, device="cuda")
        phase = (torch.rand((rows, 9, frames), generator=gen, device="cuda")
                 - 0.5) * 6.28
        ours = stft.istft(mag, phase, 16, 4, 16)
        plain = torch.istft(torch.polar(mag, phase), 16, 4, 16,
                            window=torch.hann_window(16, device="cuda"),
                            center=True)
        assert (ours - plain).abs().max().item() <= 1e-6
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = stft.istft(mag, phase, 16, 4, 16)
        graph.replay()
        assert torch.equal(captured, ours)

