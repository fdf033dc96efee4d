"""The serving programs (`infer/programs.py`), their cache
(`infer/graphs.py`) and the port's iSTFT, on the CPU.

On the CPU a program's body runs directly, so these hold the bodies, the
knobs as 0-dim tensors and the noise drawn outside the programs to the
eager model methods the serving module called before them (a seeded
request bit for bit, the generator left in the same state), and the
cache's keys to the JAX package's keying (one program per input
signature and output rate, whatever the knob values). The graphs
themselves need a card: `tests/test_torch_port_graphs_card.py`.

The iSTFT (torch.istft's ops without its host check) is held to JAX's
`istft` / `istft_riq` within 1e-5 and to `torch.istft` within 1e-6 at
both decoder heads' shapes, and divides by 1 where the window's envelope
vanishes, as JAX does. Tiny configs of torch_port_data.py, seeded random
weights, two torch threads.
"""

from __future__ import annotations

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mb_istft_vits_torch.infer import programs
from mb_istft_vits_torch.infer.graphs import KnobCache
from mb_istft_vits_torch.infer.synthesis import SynthesisModule
from tests.torch_port_data import MS_CONFIG, write_tiny_config

EN_TEXTS = ["ðə kwˈɪk bɹˈaʊn fˈɑːks.", "həlˈoʊ wˈɜːld, ðə dˈɑːɡ.",
            "ðə lˈeɪzi dˈɑːɡ slˈiːps."]
JP_TEXT = "k o N n i t i w a"
KNOBS = (0.667, 1.0, 0.8)  # noise_scale, length_scale, noise_scale_w
PAIRS = [(32, 64), (64, 128)]  # (text, frame) buckets


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads, as the suite's other port files."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    """{variant: tiny config path}: the flagship, the 12-speaker
    multi-stream model, the flagship with the stochastic predictor."""
    out = {}
    for name, base in (("flagship", None), ("ms", MS_CONFIG), ("sdp", None)):
        root = str(tmp_path_factory.mktemp(name))
        path = (write_tiny_config(root) if base is None
                else write_tiny_config(root, base))
        if name == "sdp":
            with open(path) as f:
                cfg = json.load(f)
            cfg["model"]["use_sdp"] = True
            with open(path, "w") as f:
                json.dump(cfg, f)
        out[name] = path
    return out


def _module(path, dtype=torch.float32):
    sm = SynthesisModule(path, None, None, 0, dtype, device="cpu")
    sm.TEXT_BUCKETS = (32, 64)
    sm.FRAME_BUCKETS = (64, 128, 256)
    return sm


def _ids(sm, tb, seed):
    """Padded ids [1, tb] of a random length below tb, and the length."""
    rs = np.random.RandomState(seed)
    k = rs.randint(tb // 2 + 1, tb)
    x = np.zeros((1, tb), np.int64)
    x[0, :k] = rs.randint(1, sm.cfg.n_vocab, k)
    return torch.from_numpy(x), torch.tensor([k])


def _sid(sm, sid):
    return None if sm.cfg.n_speakers <= 0 else torch.tensor([sid])


def _draw_w_eps(sm, gen, tb):
    return (torch.randn((1, tb, 2), generator=gen) if sm.cfg.use_sdp
            else None)


def _knobs(*values):
    return [torch.tensor(v, dtype=torch.float32) for v in values]


@pytest.mark.parametrize("pair", PAIRS, ids=str)
@pytest.mark.parametrize("variant", ["flagship", "ms", "sdp"])
def test_bodies_equal_the_eager_methods(configs, variant, pair):
    """Each body, knobs as tensors and the noise drawn outside it, is the
    eager method it stands for, bit for bit (speaker 5 on the 12-speaker
    model)."""
    tb, fb = pair
    sm = _module(configs[variant])
    model = sm.model
    x, xl = _ids(sm, tb, seed=tb)
    sid = _sid(sm, 5)
    ns, ls, nsw = KNOBS
    with torch.no_grad():
        gen = torch.Generator().manual_seed(3)
        w_eps = _draw_w_eps(sm, gen, tb)
        frames = model.predict_frames(x, xl, sid, ls, nsw, w_eps=w_eps)
        out = model.infer(x, xl, sid, ns, ls, nsw, fb, w_eps=w_eps,
                          generator=gen)
        gen = torch.Generator().manual_seed(3)
        w_eps = _draw_w_eps(sm, gen, tb)
        lat = model.infer_z_only(x, xl, sid, ns, ls, nsw, fb, w_eps=w_eps,
                                 generator=gen)
        z = out.latents[0]
        _, _, spec, phase = model.decode(z, sid)
        tail = model.decode_spec_tail(spec, phase)

        gen = torch.Generator().manual_seed(3)
        w_eps = _draw_w_eps(sm, gen, tb)
        eps = sm._eps(gen, 1, fb)
        t_ns, t_ls, t_nsw = _knobs(*KNOBS)
        got_frames = programs.probe(model, x, xl, sid, t_ls, t_nsw, w_eps)
        pcm, y_lengths, got_z = programs.infer(
            model, x, xl, sid, t_ns, t_ls, t_nsw, eps, w_eps,
            max_frames=fb, want_z=True)
        got_lat = programs.latents(model, x, xl, sid, t_ns, t_ls, t_nsw, eps,
                                   w_eps, max_frames=fb)
        got_spec = programs.decode_spec(model, z, sid)
    assert torch.equal(got_frames, frames)
    assert torch.equal(pcm, programs._pcm16(out.o))
    assert torch.equal(y_lengths, out.y_lengths)
    assert torch.equal(got_z, z)
    assert torch.equal(got_lat[0], lat[3][0])
    assert torch.equal(got_lat[1], lat[2])
    assert torch.equal(got_lat[2], lat[0].sum(dim=1))
    assert torch.equal(programs.decode_pcm(model, z, sid),
                       programs._pcm16(model.decode(z, sid)[0]))
    assert torch.equal(got_spec[0], spec) and torch.equal(got_spec[1], phase)
    assert torch.equal(programs.spec_tail(model, spec, phase), tail[..., 0])


def _eager_request(sm, text, sid, seed, bucket=None):
    """The serving module's request as it ran before its programs: the
    probe and model.infer drawing the prior's noise from the generator,
    Python-float knobs. -> (audio, frame bucket, generator)."""
    ids = sm.text_to_ids(text)
    x, xl = sm._pad_ids(ids)
    gen = sm._rng(seed)
    sid_t = _sid(sm, 0 if sid is None else sid)
    ns, ls, nsw = KNOBS
    with torch.no_grad():
        w_eps = (torch.randn((1, x.shape[1], 2), generator=gen)
                 if sm.cfg.use_sdp else None)
        if bucket is None:
            frames = int(sm.model.predict_frames(x, xl, sid_t, ls, nsw,
                                                 w_eps=w_eps)[0])
            bucket = sm._frame_bucket_capped(frames)
        out = sm.model.infer(x, xl, sid_t, ns, ls, nsw, bucket, w_eps=w_eps,
                             generator=gen)
    pcm = programs._pcm16(out.o)[0].numpy()
    y_len = int(out.y_lengths[0])
    audio = (pcm.astype(np.float32) / 32767.0)[: y_len * sm.hop_length]
    return audio, bucket, gen


@pytest.mark.parametrize("variant", ["flagship", "ms", "sdp"])
def test_seeded_request_equals_the_eager_path(configs, variant):
    """synthesize(seed=s) through the programs is the eager request at
    the same seed, bit for bit; so is prepare_shared_latents' z."""
    sm = _module(configs[variant])
    text = JP_TEXT if variant == "ms" else EN_TEXTS[0]
    sid = 5 if variant == "ms" else None
    want, bucket, _ = _eager_request(sm, text, sid, seed=11)
    got, tm = sm.synthesize(text, sid, seed=11)
    assert tm["frame_bucket"] == bucket
    assert np.array_equal(got, want)
    z, y_len, _ = sm.prepare_shared_latents(text, sid, seed=11)
    assert z.shape[0] == y_len == want.size // sm.hop_length


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_tensor_knobs_equal_python_floats(configs, dtype):
    """The model's methods give the same bits for 0-dim float32 knobs as
    for Python floats, in both compute dtypes (the stochastic predictor's
    noise_scale_w included)."""
    for variant in ("flagship", "sdp"):
        sm = _module(configs[variant], dtype)
        x, xl = _ids(sm, 32, seed=1)
        gen = torch.Generator().manual_seed(0)
        w_eps = _draw_w_eps(sm, gen, 32)
        eps = sm._eps(gen, 1, 64)
        with torch.no_grad():
            for ns, ls, nsw in ((0.667, 1.0, 0.8), (0.3, 1.3, 0.5)):
                floats = sm.model.infer(x, xl, None, ns, ls, nsw, 64,
                                        eps=eps, w_eps=w_eps)
                tensors = sm.model.infer(x, xl, None, *_knobs(ns, ls, nsw),
                                         64, eps=eps, w_eps=w_eps)
                assert torch.equal(floats.o, tensors.o), (variant, ns)
                assert torch.equal(floats.latents[0], tensors.latents[0])
                assert torch.equal(
                    sm.model.predict_frames(x, xl, None, ls, nsw,
                                            w_eps=w_eps),
                    sm.model.predict_frames(x, xl, None, *_knobs(ls, nsw),
                                            w_eps=w_eps))


def test_noise_order_leaves_the_generator_as_eager(configs):
    """An unseeded request and an unseeded batch draw w_eps, then the
    prior's eps, from the module's stream: the stream ends where the
    eager path leaves it, and the audio is the eager path's."""
    sm = _module(configs["sdp"])
    twin = _module(configs["sdp"])
    want, bucket, gen = _eager_request(twin, EN_TEXTS[1], None, None)
    got, tm = sm.synthesize(EN_TEXTS[1])
    assert tm["frame_bucket"] == bucket and np.array_equal(got, want)
    assert torch.equal(sm._generator.get_state(), gen.get_state())

    sm.synthesize_batch(EN_TEXTS, seed=None)
    # the batch's draws, eagerly: w_eps [nb, T_x, 2], then eps [nb, C, fb]
    nb = sm._batch_bucket(len(EN_TEXTS))
    t_x = max(len(sm.text_to_ids(t)) for t in EN_TEXTS)
    t_x = next(b for b in sm.TEXT_BUCKETS if b >= t_x)
    w_eps = torch.randn((nb, t_x, 2), generator=gen)
    ids = [twin.text_to_ids(t) for t in EN_TEXTS]
    x = torch.zeros((nb, t_x), dtype=torch.int64)
    xl = torch.ones((nb,), dtype=torch.int64)
    for i, row in enumerate(ids):
        x[i, : len(row)] = torch.from_numpy(row.astype(np.int64))
        xl[i] = len(row)
    with torch.no_grad():
        frames = twin.model.predict_frames(x, xl, None, 1.0, 0.8,
                                           w_eps=w_eps)
        twin.model.infer(x, xl, None, *KNOBS,
                         twin._frame_bucket_capped(int(frames.max())),
                         w_eps=w_eps, generator=gen)
    assert torch.equal(sm._generator.get_state(), gen.get_state())


def _keys(sm, program):
    return [k for k in sm.graphs.keys() if k[0] == program]


def test_cache_keys_follow_the_input_signature(configs):
    """Two texts of one text bucket at one frame bucket share the infer
    and probe keys; a new frame bucket or output rate makes a new key; a
    new knob value does not (JAX: one program per static shape, knobs as
    device scalars)."""
    sm = _module(configs["flagship"])
    gen = torch.Generator().manual_seed(0)
    for seed in (1, 2):
        x, xl = _ids(sm, 32, seed)
        sm._predict_frames(x, xl, None, 1.0, 0.8, None)
        sm._infer(x, xl, None, *KNOBS, 64, gen, None)
    assert len(_keys(sm, "probe")) == 1 and len(_keys(sm, "infer")) == 1
    sm._infer(x, xl, None, 0.3, 1.2, 0.5, 64, gen, None)
    sm._predict_frames(x, xl, None, 1.2, 0.5, None)
    assert len(_keys(sm, "infer")) == 1 and len(_keys(sm, "probe")) == 1
    assert sm._knob(0.3, sm.device) is sm._knob(0.3, sm.device)
    sm._infer(x, xl, None, *KNOBS, 128, gen, None)
    assert len(_keys(sm, "infer")) == 2
    sm._infer(x, xl, None, *KNOBS, 128, gen, None, out_sr=16000)
    assert len(_keys(sm, "infer")) == 3
    sm._infer(x, xl, None, *KNOBS, 128, gen, None, out_sr=sm.sampling_rate)
    assert len(_keys(sm, "infer")) == 3  # the model's own rate: no resample
    # the serving routes: one key per program and signature
    sm.synthesize(EN_TEXTS[0], seed=0)
    sm.synthesize(EN_TEXTS[2], seed=0)
    assert sm.graphs.captures == 0  # nothing is captured on the CPU
    z, _, _ = sm.prepare_shared_latents(EN_TEXTS[0], seed=0)
    sm.decode_spec_join(z, chunk_frames=16, overlap_frames=4)
    for program in ("latents", "decode_spec", "spec_tail"):
        assert _keys(sm, program), program


def _stft_modules():
    return (importlib.import_module("mb_istft_vits_tpu.dsp.stft"),
            importlib.import_module("mb_istft_vits_torch.dsp.stft"))


# (rows, frames) of the per-band iSTFT of the MB-iSTFT head (4 bands of one
# utterance, 64 latent frames x 16) and of the iSTFT head's (x 64)
HEADS = {"mb_istft": (4, 1024), "istft": (1, 4096)}


@pytest.mark.parametrize("head", sorted(HEADS))
def test_istft_matches_jax_and_torch(head):
    jax_stft, port_stft = _stft_modules()
    rows, frames = HEADS[head]
    rs = np.random.RandomState(frames)
    mag = rs.rand(rows, 9, frames).astype(np.float32) * 2
    phase = ((rs.rand(rows, 9, frames) - 0.5) * 2 * np.pi).astype(np.float32)
    ours = port_stft.istft(torch.from_numpy(mag), torch.from_numpy(phase),
                           16, 4, 16).numpy()
    ref = np.asarray(jax_stft.istft(jnp.asarray(mag), jnp.asarray(phase),
                                    16, 4, 16))
    assert ours.shape == ref.shape == (rows, (frames - 1) * 4)
    assert np.abs(ours - ref).max() <= 1e-5
    plain = torch.istft(torch.polar(torch.from_numpy(mag),
                                    torch.from_numpy(phase)), 16, 4, 16,
                        window=torch.hann_window(16), center=True).numpy()
    assert np.abs(ours - plain).max() <= 1e-6
    riq = np.concatenate([mag * np.cos(phase), mag * np.sin(phase)],
                         axis=1).transpose(0, 2, 1).copy()
    ours_riq = port_stft.istft_riq(torch.from_numpy(riq), 16, 4, 16).numpy()
    ref_riq = np.asarray(jax_stft.istft_riq(jnp.asarray(riq), 16, 4, 16))
    assert np.abs(ours_riq - ref_riq).max() <= 1e-5


def test_istft_divides_by_one_where_the_envelope_vanishes():
    """An 8-sample window in 16-sample frames one frame apart: the
    envelope is 0 between the windows. JAX divides by 1 there, the port
    too; torch.istft refuses."""
    jax_stft, port_stft = _stft_modules()
    rs = np.random.RandomState(0)
    mag = rs.rand(2, 9, 20).astype(np.float32)
    phase = ((rs.rand(2, 9, 20) - 0.5) * 2 * np.pi).astype(np.float32)
    for center in (True, False):
        ours = port_stft.istft(torch.from_numpy(mag),
                               torch.from_numpy(phase), 16, 16, 8,
                               center).numpy()
        ref = np.asarray(jax_stft.istft(jnp.asarray(mag), jnp.asarray(phase),
                                        16, 16, 8, center))
        assert ours.shape == ref.shape
        assert np.isfinite(ours).all()
        assert np.abs(ours - ref).max() <= 1e-5, center
    with pytest.raises(RuntimeError):
        torch.istft(torch.polar(torch.from_numpy(mag),
                                torch.from_numpy(phase)), 16, 16, 8,
                    window=port_stft.hann_window(8), center=False)


def test_istft_envelope_is_made_once_per_shape():
    port_stft = _stft_modules()[1]
    mag = torch.rand(1, 9, 30)
    port_stft.istft(mag, mag, 16, 4, 16)
    kept = dict(port_stft._SYNTHESIS)
    port_stft.istft(mag * 2, mag, 16, 4, 16)
    assert port_stft._SYNTHESIS == kept
    key = (16, 4, 16, 30, mag.device)
    win, env = kept[key]
    assert win.shape == (16,) and env.shape == (16 + 4 * 29,)
    assert bool((env > 0).all())


def test_graph_cache_refuses_a_python_number_input():
    from mb_istft_vits_torch.infer.graphs import GraphCache

    with pytest.raises(TypeError, match="tensor or None"):
        GraphCache().run(("p",), lambda a: a, (1.0,), torch.device("cpu"))



def test_a_knob_is_one_float32_scalar_per_value_and_device():
    """Both serving classes' knob cache: the same tensor for a value
    again, a new one for another value or device, cleared past LIMIT."""
    knobs = KnobCache()
    a = knobs(0.667, torch.device("cpu"))
    assert a.dim() == 0 and a.dtype == torch.float32 and float(a) == \
        pytest.approx(0.667)
    assert knobs(0.667, "cpu") is a and knobs(0.5, "cpu") is not a
    for i in range(KnobCache.LIMIT + 1):
        knobs(float(i), "cpu")
    assert knobs(0.667, "cpu") is not a
