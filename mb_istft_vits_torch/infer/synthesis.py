"""Serving module: text -> waveform with static shape buckets, stage
timings, batched, chunked, spectrogram-joined and streaming decode
(counterpart of `mb_istft_vits_tpu/infer/synthesis.py:SynthesisModule`,
with its public surface: method names, arguments, returns and timings).

Text lengths and output frames are padded to bucket sizes, as in the JAX
package, where each program (the duration probe, infer, latents, decode
to PCM, decode to spec, the spec tail) is compiled once per static shape.
Here each is a body of `infer.programs` and, on a card, a CUDA graph
captured on the first call at its input signature and replayed after
that (`infer.graphs`: one graph per program, device, input shapes and
dtypes, output rate), so a request is a few graph launches. `warmup()`
captures the pairs it runs ahead of traffic. The knobs are 0-dim float32
device tensors, kept per value (JAX's `_dev_scalar`), so one graph serves
every knob value. The noise is drawn outside the graphs from the
request's generator, in the eager order: `w_eps` first (with the
stochastic duration predictor), then the prior's `eps` in the compute
dtype. A decode that fills its bucket is retried at a larger one, which
captures there (JAX compiles there too). On the CPU the bodies run
directly.

While a profiler runs, the module records spans
(`utils.observability.span`): `synth.probe`, the duration probe from its
launch to the frame bucket known on the host; `synth.dispatch`, the host
queueing a decode (the noise, the graphs, the copy back); `synth.retry`,
a decode redone at a larger bucket, the whole redo. It also counts
(`utils.observability.record_count`) each decode of a request or a batch
as `synth.frames`: (rows of the batch bucket, frame bucket, each real
row's frames, each real row's ids).

Device traffic: inputs go up through pinned memory without blocking;
audio comes back as int16 PCM (half the bytes of f32), quantized on the
device. The chunked paths run a one-deep pipeline: chunk i+1 is enqueued
before the host waits for chunk i, whose copy to pinned memory was
enqueued right behind its own decode, so the wait does not include chunk
i+1's compute. On the CPU the same code runs in plain order.

Speakers: on a multi-speaker model every route conditions on its `sid`
(`sids` per row in `synthesize_batch`); `None` means speaker 0, as in the
JAX package. Raw (not pre-cleaned) Japanese text runs the config's
cleaners, which take katakana.

Durations: with the stochastic duration predictor (`use_sdp`) every
route samples them at `noise_scale_w`. A request draws the predictor's
noise once, first from its generator, and hands the same draw to the
frame-bucket probe and to the decode (the JAX package passes one key to
both programs), so the probe's frames are the decode's.

Precision: `compute_dtype` (float32 by default; bfloat16 as the JAX
package serves on a TPU) is the dtype of every floating parameter and
buffer and of the model's activations, the duration predictor included,
so bf16 frames are JAX-bf16 frames; the explicit draws are cast to it
where they are used. The spec-phase head and everything after it (the
iSTFT, the sub-band synthesis, the resampler and the PCM) run in float32:
`torch.istft` has no bfloat16 on the card, where the JAX package runs
its iSTFT and PQMF as bf16 matmuls.

The serving mesh (`mesh`, a list of devices): one replica of the
generator per device, and `synthesize_batch`, `decode_chunks_batched`
and batched `decode_spec_join` split their rows evenly over the replicas
(JAX shards the same batches over its mesh's "data" axis). Every
device's work is queued before the first copy back, so the cards
overlap. The noise is drawn once for the whole batch, on the first
device, and sliced by row, so a row's audio does not depend on the mesh,
as in JAX, where the noise is one global draw that is then sharded.

Threads: the serving entry points may be called from several threads at
once (the micro-batcher's two workers). The text caches are locked; the
graphs are replayed one at a time, in the order their callers queue them
on the card (`infer.graphs`); a seeded request draws from a generator of
its own, so its audio does not depend on what runs beside it.

Not ported: Orbax checkpoints (the port reads reference `.pth` files).
`aot_cache_dir` is accepted and unused: a CUDA graph cannot be written to
disk, so every process captures its own.
"""

from __future__ import annotations

import bisect
import copy
import functools
import math
import threading
import time
from collections import OrderedDict
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from mb_istft_vits_torch.config import Config
from mb_istft_vits_torch.device import disable_tf32, resolve_device
from mb_istft_vits_torch.infer import programs
from mb_istft_vits_torch.infer.graphs import GraphCache, KnobCache
from mb_istft_vits_torch.models import Synthesizer
from mb_istft_vits_torch.parallel.mesh import (
    mesh_devices,
    mesh_size,
    shard_batch,
)
from mb_istft_vits_torch.text import frontend_ids, get_symbols
from mb_istft_vits_torch.utils.observability import (now_ns, record_count,
                                                      record_span, recording,
                                                      span)
from mb_istft_vits_torch.weights import load_generator_pth

_instances: Dict[str, "SynthesisModule"] = {}

# pause / punctuation symbols: phrase boundaries for the long-text split
# and the phrase-level decode (the same set in the EN and JP tables)
_BOUNDARY_SYMBOLS = frozenset({"、", "。", ",", ".", "?", "!", "…", "sp",
                               "pau", " "})


def get_synthesis_module_instance(config_path: str,
                                  checkpoint_path: Optional[str] = None,
                                  **kwargs) -> "SynthesisModule":
    """One module per (config, checkpoint, device) in the process."""
    key = f"{config_path}::{checkpoint_path}::{kwargs.get('device')}"
    if key not in _instances:
        _instances[key] = SynthesisModule(config_path, checkpoint_path,
                                          **kwargs)
    return _instances[key]


def _next_bucket(n: int, buckets: Sequence[int], granule: int = 64) -> int:
    """Smallest bucket >= n; beyond the table, round up to `granule`."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // granule) * granule


class SynthesisModule:
    """Loads a config and generator weights (`params`, a state dict with
    the reference names; else a reference `G_*.pth`; else random weights
    from `seed`) and serves text on `device` (CUDA unless "cpu" is asked
    for; no fallback) in `compute_dtype`. The positional order is the JAX
    package's (config_path, checkpoint_path, params, seed, compute_dtype,
    mesh, aot_cache_dir); `device` is the port's own and keyword-only.

    `mesh`: None, or a list of one device, serves on one device (JAX's
    `mesh.size > 1` rule); a list of more (`parallel.create_mesh(n)`, or
    the same card twice) keeps a replica of the generator on each and fans
    batches out over them; `device` then defaults to the mesh's first,
    which holds the noise generator. `aot_cache_dir`: accepted for JAX's
    callers and not used (a CUDA graph cannot be stored; JAX itself
    ignores it where its cache is unusable or a mesh is set).

    `graphs` is the module's `infer.graphs.GraphCache` (its captures,
    replays and capture seconds)."""

    TEXT_BUCKETS = (32, 64, 128, 192, 256, 384)
    FRAME_BUCKETS = (128, 192, 256, 384, 512, 768, 1024, 1536, 2048)
    # frame buckets stop growing here (~3 min of audio at 22.05 kHz, hop 256)
    MAX_FRAMES = 16384
    # the rel-pos attention holds [1, H, T_x, T_x] per layer; longer texts
    # are split at phrase boundaries into pieces of at most this many ids
    MAX_TEXT_TOKENS = 1024
    BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)

    def __init__(self, config_path: str,
                 checkpoint_path: Optional[str] = None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, compute_dtype: torch.dtype = torch.float32,
                 mesh=None, aot_cache_dir: Optional[str] = None, *,
                 device: Optional[Union[str, torch.device]] = None):
        if not (isinstance(compute_dtype, torch.dtype)
                and compute_dtype.is_floating_point):
            raise TypeError(f"compute_dtype must be a floating torch.dtype, "
                            f"not {compute_dtype!r}")
        mesh = mesh_devices(mesh) if mesh_size(mesh) > 1 else None
        self.mesh = mesh
        self.aot_cache_dir = aot_cache_dir
        if mesh is not None and device is None:
            device = mesh[0]
        dev = self._indexed(resolve_device(device))
        self.device = dev
        if dev.type == "cuda":
            disable_tf32()
            # cuDNN's default algorithms for some convolutions accumulate
            # in a run-dependent order, so equal inputs could give PCM one
            # step apart from call to call; serving takes the
            # deterministic ones, so a seeded request (and a row the
            # micro-batcher coalesced) is reproducible bit for bit.
            # Process-wide, like the TF32 switch.
            torch.backends.cudnn.deterministic = True
        self.config = Config.from_json(config_path)
        self.cfg, self.data_cfg = self.config.model, self.config.data
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = Synthesizer(self.cfg)
        if params is not None:
            model.load_state_dict(params)
        elif checkpoint_path is not None:
            model.load_state_dict(load_generator_pth(checkpoint_path))
        self.model = model.to(dev).eval()
        self.compute_dtype = compute_dtype
        if compute_dtype != torch.float32:
            keep = tuple(f"dec.{p}" for p in model.dec.FLOAT32_TAIL)
            for name, v in [*model.named_parameters(),
                            *model.named_buffers()]:
                if v.is_floating_point() and not name.startswith(keep):
                    v.data = v.data.to(compute_dtype)
        # (device, model) of each mesh position; positions on one device
        # share its replica
        self._replicas = [(dev, self.model)]
        if mesh is not None:
            on = {dev: self.model}
            self._replicas = []
            for d in map(self._indexed, mesh):
                if d not in on:
                    on[d] = copy.deepcopy(self.model).to(d)
                self._replicas.append((d, on[d]))
        self.hop_length = self.data_cfg.hop_length
        self.sampling_rate = self.data_cfg.sampling_rate
        # unseeded requests draw from this stream, in call order
        self._generator = torch.Generator(dev).manual_seed(seed)
        # adaptive tokens -> frames ratio for the frame bucket; until the
        # first observation the duration probe picks the bucket. Callers on
        # several threads (the micro-batcher's workers) race on it, and
        # harmlessly: a lost update only picks another bucket estimate, the
        # bucket a decode ran at is reported, and one that fills is redone
        self._frames_per_token = 3.0
        self._ratio_observed = False
        # repeated texts skip the frontend and reuse their device inputs;
        # the lock makes each cache's lookup and eviction one step for
        # callers on several threads
        self._ids_cache: "OrderedDict" = OrderedDict()
        self._x_cache: "OrderedDict" = OrderedDict()
        self._cache_lock = threading.Lock()
        # the serving programs' graphs on a card; knob values as device
        # scalars, per (value, device): two threads may make one value
        # twice, and either tensor serves, since every replay copies its
        # inputs into the graph's own buffers
        self.graphs = GraphCache()
        self._knobs = KnobCache()

    # ------------------------------------------------------------------
    # host <-> device
    # ------------------------------------------------------------------
    @staticmethod
    def _indexed(dev: torch.device) -> torch.device:
        """A CUDA device with an explicit index: worker threads must not
        depend on their own current device."""
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return dev

    def _to_device(self, a: np.ndarray,
                   device: Optional[torch.device] = None) -> torch.Tensor:
        """numpy -> tensor on `device` (the module's by default); on CUDA
        through pinned memory, without waiting for the work already
        queued."""
        device = device or self.device
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type != "cuda":
            return t
        return t.pin_memory().to(device, non_blocking=True)

    def _latents_to_device(self, z: np.ndarray) -> torch.Tensor:
        """Host latents (float32) -> the device, in the compute dtype."""
        return self._to_device(z).to(self.compute_dtype)

    def _shard(self, batch):
        """`batch` (tensors on the first device) split evenly by rows over
        the mesh positions: part i on position i's device (`shard_batch`;
        without a mesh, one part)."""
        return shard_batch(batch, [dev for dev, _ in self._replicas])

    def _fetch(self, tensors: Sequence[torch.Tensor]
               ) -> Callable[[], List[np.ndarray]]:
        """Start copying `tensors` to the host; the returned callable
        waits for the copy and gives numpy arrays. On CUDA the copies go
        to pinned memory behind the work already queued, so later work
        can be queued before the wait."""
        # numpy has no bfloat16: such tensors come back as float32
        tensors = [t.float() if t.dtype == torch.bfloat16 else t
                   for t in tensors]
        if self.device.type != "cuda":
            arrays = [t.numpy() for t in tensors]
            return lambda: arrays
        hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in tensors]
        for h, t in zip(hosts, tensors):
            h.copy_(t, non_blocking=True)
        done = []
        for dev in dict.fromkeys(t.device for t in tensors):
            with torch.cuda.device(dev):
                done.append(torch.cuda.Event())
                done[-1].record(torch.cuda.current_stream(dev))

        def wait() -> List[np.ndarray]:
            for ev in done:
                ev.synchronize()
            return [h.numpy() for h in hosts]

        return wait

    def _sid_rows(self, n: int, sid: Optional[int],
                  device: Optional[torch.device] = None
                  ) -> Optional[torch.Tensor]:
        """Speaker ids [n] on the device for `n` rows of one speaker
        (`None`: speaker 0), or None when the model has no speakers
        (JAX `_sid` / `_sid_rows`)."""
        if self.cfg.n_speakers <= 0:
            return None
        return self._to_device(np.full((n,), 0 if sid is None else int(sid),
                                       np.int64), device)

    def _rng(self, seed: Optional[int]) -> torch.Generator:
        """A generator freshly seeded with `seed` (so equal seeds give
        equal noise whatever ran before), else the module's own stream."""
        if seed is None:
            return self._generator
        return torch.Generator(self.device).manual_seed(int(seed))

    def _draws(self, shape: Sequence[int], seed: Optional[int]
               ) -> Tuple[torch.Generator, Optional[torch.Tensor]]:
        """(generator, w_eps) of one request on padded ids of `shape`
        [B, T_x]: the stochastic duration predictor's noise [B, T_x, 2] is
        the generator's first draw (None without that predictor), the
        prior's noise comes after it. A seeded request gets the same pair
        on every call."""
        gen = self._rng(seed)
        if not self.cfg.use_sdp:
            return gen, None
        return gen, torch.randn((shape[0], shape[1], 2), generator=gen,
                                device=self.device)

    # ------------------------------------------------------------------
    # model calls: the serving programs
    # ------------------------------------------------------------------
    def _program(self, name: str, *args, replica: int = 0, **options):
        """The body `name` of `infer.programs` on mesh position `replica`'s
        model: its CUDA graph at these inputs' signature and `options` on a
        card, a direct call on the CPU."""
        dev, model = self._replicas[replica]
        body = functools.partial(getattr(programs, name), model, **options)
        return self.graphs.run((name, tuple(sorted(options.items()))),
                               body, args, dev)

    def _knob(self, v, device: torch.device) -> torch.Tensor:
        """A knob as a 0-dim float32 tensor on `device`, kept per value."""
        return self._knobs(v, device)

    def _knobs_on(self, replica: int, *values) -> List[torch.Tensor]:
        dev = self._replicas[replica][0]
        return [self._knob(v, dev) for v in values]

    def _eps(self, gen: torch.Generator, rows: int, frames: int
             ) -> torch.Tensor:
        """The prior's noise [rows, frames, C] in the compute dtype, drawn
        from `gen` as `Synthesizer.infer` draws it ([rows, C, frames])."""
        return torch.randn((rows, self.cfg.inter_channels, frames),
                           generator=gen, dtype=self.compute_dtype,
                           device=self.device).transpose(1, 2)

    def _predict_frames(self, x, x_lengths, sid, length_scale,
                        noise_scale_w, w_eps, replica: int = 0
                        ) -> torch.Tensor:
        """The duration probe: predicted frames [B] (int32) on the
        device."""
        return self._program(
            "probe", x, x_lengths, sid,
            *self._knobs_on(replica, length_scale, noise_scale_w), w_eps,
            replica=replica)

    def _infer(self, x, x_lengths, sid, noise_scale, length_scale,
               noise_scale_w, max_frames, generator, w_eps,
               out_sr: Optional[int] = None, eps=None, replica: int = 0,
               want_z: bool = False):
        """sid: device ids [B] or None -> (int16 PCM [B, T_wav(out_sr)],
        y_lengths [B]) on the device, and z [B, max_frames, C] with
        `want_z`. eps (the prior's noise) is drawn from `generator` when
        not given."""
        if eps is None:
            eps = self._eps(generator, len(x), max_frames)
        resample = (None if out_sr in (None, self.sampling_rate)
                    else (self.sampling_rate, int(out_sr)))
        return self._program(
            "infer", x, x_lengths, sid,
            *self._knobs_on(replica, noise_scale, length_scale,
                            noise_scale_w), eps, w_eps,
            replica=replica, max_frames=int(max_frames),
            resample=resample, want_z=want_z)

    def _latents(self, x, x_lengths, sid, noise_scale, length_scale,
                 noise_scale_w, max_frames, generator, w_eps):
        """-> (z [B, max_frames, C], y_lengths [B], frames per token
        [B, T_x]) on the device, the prior's noise drawn from
        `generator`."""
        return self._program(
            "latents", x, x_lengths, sid,
            *self._knobs_on(0, noise_scale, length_scale, noise_scale_w),
            self._eps(generator, len(x), max_frames), w_eps,
            max_frames=int(max_frames))

    def _decode_pcm(self, z: torch.Tensor, sid: Optional[int] = None,
                    replica: int = 0) -> torch.Tensor:
        """z windows [N, T, C] of speaker `sid`, on the device of mesh
        position `replica` -> int16 PCM [N, T * hop] there."""
        dev = self._replicas[replica][0]
        return self._program("decode_pcm", z,
                             self._sid_rows(len(z), sid, dev),
                             replica=replica)

    def _decode_spec(self, z: torch.Tensor, sid: Optional[int] = None,
                     replica: int = 0):
        """z windows [N, T, C] of speaker `sid`, on the device of mesh
        position `replica` -> (spec, phase) there, [N, F, s, bins]
        ([N, F, bins] for the iSTFT head)."""
        self._require_spectrogram("decode_spec")
        dev = self._replicas[replica][0]
        return self._program("decode_spec", z,
                             self._sid_rows(len(z), sid, dev),
                             replica=replica)

    def _require_spectrogram(self, route: str) -> None:
        """Raise for a spectrogram-domain route on a head without one."""
        if self.cfg.decoder_kind == "hifigan":
            raise ValueError(
                f"{route} joins the decoder's spectrogram, and the HiFi-GAN "
                "head has none: it decodes to a waveform directly (decode "
                "chunks with stream_from_latents or decode_chunks_batched)")

    # ------------------------------------------------------------------
    # text frontend
    # ------------------------------------------------------------------
    def text_to_ids(self, text: str, cleaned: Optional[bool] = None
                    ) -> np.ndarray:
        """Token ids (int32, read-only, cached per (text, cleaned));
        `cleaned` overrides the config's `cleaned_text`. Uncleaned text
        runs the config's cleaners; for a Japanese config they take
        katakana (`japanese_cleaners`), where the JAX package serves raw
        kanji/kana through pyopenjtalk, which the port does not carry."""
        cfg = self.data_cfg
        cleaned = cfg.cleaned_text if cleaned is None else cleaned
        key = (text, cleaned)
        with self._cache_lock:
            hit = self._ids_cache.get(key)
            if hit is not None:
                self._ids_cache.move_to_end(key)
                return hit
        ids = np.asarray(frontend_ids(text, cfg.text_module, cfg.text_cleaners,
                                      cfg.add_blank, cleaned), np.int32)
        ids.setflags(write=False)  # shared across cache hits
        with self._cache_lock:
            self._ids_cache[key] = ids
            while len(self._ids_cache) > 1024:
                self._ids_cache.popitem(last=False)
        return ids

    def _pad_ids(self, ids: np.ndarray
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = _next_bucket(len(ids), self.TEXT_BUCKETS)
        x = np.zeros((1, t), np.int64)
        x[0, : len(ids)] = ids
        return (self._to_device(x),
                self._to_device(np.asarray([len(ids)], np.int64)))

    def _pad_ids_cached(self, ids: np.ndarray
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-resident (x, x_lengths) for an id sequence, cached so a
        repeated text uploads nothing."""
        key = ids.tobytes()
        with self._cache_lock:
            hit = self._x_cache.get(key)
            if hit is not None:
                self._x_cache.move_to_end(key)
                return hit
        pair = self._pad_ids(ids)
        with self._cache_lock:
            self._x_cache[key] = pair
            while len(self._x_cache) > 256:
                self._x_cache.popitem(last=False)
        return pair

    def _frame_bucket_capped(self, n: int) -> int:
        """Frame bucket for n frames, capped at MAX_FRAMES before any
        decode runs at it."""
        return min(_next_bucket(n, self.FRAME_BUCKETS), self.MAX_FRAMES)

    def _frames_bucket(self, x, x_lengths, sid, length_scale, noise_scale_w,
                       w_eps) -> int:
        """Exact output-frame bucket from the duration probe (text
        encoder + duration predictor only), under the decode's `w_eps`."""
        with span("synth.probe"):
            frames = int(self._predict_frames(x, x_lengths, sid,
                                              length_scale, noise_scale_w,
                                              w_eps)[0])
        return self._frame_bucket_capped(frames)

    def warmup(self, pairs: Optional[Sequence[Tuple[int, int]]] = None
               ) -> None:
        """Run the duration probe and the decode once at each of
        ``pairs`` (text_bucket, frame_bucket) ahead of traffic, so live
        requests at those shapes pay no per-shape set-up: on a card this
        captures their graphs. The default takes each text bucket with its
        expected frame bucket (tokens x the adaptive frames-per-token
        ratio). Runs as speaker 0 (a model with speakers) at the default
        knobs; a graph serves every knob value."""
        if pairs is None:
            pairs = [
                (tb, _next_bucket(int(tb * self._frames_per_token),
                                  self.FRAME_BUCKETS))
                for tb in self.TEXT_BUCKETS
            ]
        pcm = None
        sid = self._sid_rows(1, 0)
        for tb, fb in pairs:
            x = self._to_device(np.ones((1, tb), np.int64))
            xl = self._to_device(np.asarray([tb], np.int64))
            gen, w_eps = self._draws(x.shape, 0)
            self._predict_frames(x, xl, sid, 1.0, 0.8, w_eps)
            pcm, _ = self._infer(x, xl, sid, 0.667, 1.0, 0.8, fb, gen, w_eps)
        if pcm is not None:
            self._fetch([pcm[:, :1]])()  # sync: every shape has run

    # ------------------------------------------------------------------
    # synthesis entry points
    # ------------------------------------------------------------------
    def synthesize_with_z(
        self,
        text: str,
        sid: Optional[int] = None,
        noise_scale: float = 0.667,
        length_scale: float = 1.0,
        noise_scale_w: float = 0.8,
        cleaned: Optional[bool] = None,
        seed: Optional[int] = None,
    ):
        """-> (audio, z [y_len, C], timings)."""
        return self._synthesize_impl(
            text, sid, noise_scale, length_scale, noise_scale_w, cleaned,
            seed, want_z=True)

    def synthesize(self, text: str, sid: Optional[int] = None, **kwargs):
        """-> (float32 audio on the int16 grid [y_len * hop], timings) of
        speaker `sid`. Keywords: noise_scale, length_scale, noise_scale_w
        (the stochastic duration predictor's noise; no effect on a model
        with the deterministic one), cleaned, seed."""
        audio, _, timings = self._synthesize_impl(text, sid, want_z=False,
                                                  **kwargs)
        return audio, timings

    def _synthesize_impl(
        self,
        text: str,
        sid: Optional[int] = None,
        noise_scale: float = 0.667,
        length_scale: float = 1.0,
        noise_scale_w: float = 0.8,
        cleaned: Optional[bool] = None,
        seed: Optional[int] = None,
        want_z: bool = False,
    ):
        """Texts longer than MAX_TEXT_TOKENS take the phrase-split route."""
        t_start = time.perf_counter()
        ids = self.text_to_ids(text, cleaned)
        route = (self._synthesize_long if len(ids) > self.MAX_TEXT_TOKENS
                 else self._synthesize_ids)
        return route(ids, sid, noise_scale, length_scale, noise_scale_w,
                     seed, want_z, t_start)

    def _synthesize_ids(
        self,
        ids: np.ndarray,
        sid: Optional[int],
        noise_scale: float,
        length_scale: float,
        noise_scale_w: float,
        seed: Optional[int],
        want_z: bool,
        t_start: float,
    ):
        """One request: frame bucket from the adaptive ratio (the probe
        until the first observation), one decode at that bucket, one
        fetch of what the caller needs. A decode that fills its bucket
        (y_len == bucket) is redone at 1.5x the bucket. timings: `total`
        (seconds from the ids to the audio on the host), `audio_seconds`,
        `rtf`, `frame_bucket`, `frontend`, `dispatch` (queueing the
        decode), `sync` (waiting for the device and the copy)."""
        x, x_lengths = self._pad_ids_cached(ids)
        sid_arr = self._sid_rows(1, sid)
        t0 = time.perf_counter()
        t_frontend = t0 - t_start
        gen, w_eps = self._draws(x.shape, seed)

        if self._ratio_observed:
            est = int(len(ids) * self._frames_per_token * length_scale) + 16
            bucket = self._frame_bucket_capped(est)
        else:
            bucket = self._frames_bucket(x, x_lengths, sid_arr, length_scale,
                                         noise_scale_w, w_eps)
        t_dispatch = 0.0
        t_sync = 0.0
        retry_ns = None  # the start of a redo at a larger bucket
        while True:
            with span("synth.dispatch"):
                td = time.perf_counter()
                pcm16, y_lengths, *z = self._infer(
                    x, x_lengths, sid_arr, noise_scale, length_scale,
                    noise_scale_w, bucket, gen, w_eps, want_z=want_z)
                fetch = [pcm16[0], y_lengths]
                if want_z:
                    fetch.append(z[0][0])
                pending = self._fetch(fetch)
                ts = time.perf_counter()
            t_dispatch += ts - td
            host = pending()
            t_sync += time.perf_counter() - ts
            if retry_ns is not None:
                record_span("synth.retry", retry_ns, now_ns())
            y_len = int(host[1][0])
            record_count("synth.frames", (1, bucket, (y_len,), (len(ids),)))
            if y_len < bucket or bucket >= self.MAX_FRAMES:
                break
            retry_ns = now_ns()
            bucket = self._frame_bucket_capped(int(bucket * 3 / 2))
            if seed is not None:  # the same draws again, at the new bucket
                gen, w_eps = self._draws(x.shape, seed)
        # EMA toward 1.2x the observed ratio, floored at 1.1x so an
        # underestimate (a second decode) stays rare
        ratio = y_len / max(len(ids) * length_scale, 1)
        if self._ratio_observed:
            self._frames_per_token = max(
                ratio * 1.1,
                0.5 * self._frames_per_token + 0.5 * ratio * 1.2,
            )
        else:
            self._frames_per_token = ratio * 1.2
            self._ratio_observed = True
        audio = host[0].astype(np.float32) / 32767.0
        audio = audio[: y_len * self.hop_length]
        elapsed = time.perf_counter() - t0
        timings = {
            "total": elapsed,
            "audio_seconds": len(audio) / self.sampling_rate,
            "rtf": elapsed / max(len(audio) / self.sampling_rate, 1e-9),
            "frame_bucket": bucket,
            "frontend": t_frontend,
            "dispatch": t_dispatch,
            "sync": t_sync,
        }
        z = host[2][:y_len].astype(np.float32) if want_z else None
        return audio, z, timings

    def _boundary_token_positions(self, ids: np.ndarray) -> List[int]:
        """Positions in `ids` holding phrase-boundary symbols."""
        symbols = get_symbols(self.data_cfg.text_module)
        return [i for i, t in enumerate(np.asarray(ids))
                if symbols[int(t)] in _BOUNDARY_SYMBOLS]

    def _split_long_ids(self, ids: np.ndarray) -> List[np.ndarray]:
        """Split a long id sequence into <= MAX_TEXT_TOKENS pieces, cutting
        after the last phrase boundary inside each window (hard-splitting
        only a window without one)."""
        limit = int(self.MAX_TEXT_TOKENS)
        bounds = self._boundary_token_positions(ids)
        pieces, start, n = [], 0, len(ids)
        while n - start > limit:
            j = bisect.bisect_right(bounds, start + limit - 1) - 1
            cut = bounds[j] + 1 if (j >= 0 and bounds[j] > start) \
                else start + limit
            pieces.append(np.asarray(ids[start:cut]))
            start = cut
        pieces.append(np.asarray(ids[start:]))
        return [p for p in pieces if len(p)]

    def _synthesize_long(
        self,
        ids: np.ndarray,
        sid: Optional[int],
        noise_scale: float,
        length_scale: float,
        noise_scale_w: float,
        seed: Optional[int],
        want_z: bool,
        t_start: float,
    ):
        """Long-text route: each phrase-split piece goes through the
        bucketed single-request path (piece i seeded with seed + i); the
        audio (and z) are concatenated. timings add `pieces`."""
        pieces = self._split_long_ids(ids)
        audios, zs = [], []
        agg = {"frontend": time.perf_counter() - t_start, "dispatch": 0.0,
               "sync": 0.0, "frame_bucket": 0}
        for i, piece in enumerate(pieces):
            piece_seed = None if seed is None else seed + i
            audio_i, z_i, t_i = self._synthesize_ids(
                piece, sid, noise_scale, length_scale, noise_scale_w,
                piece_seed, want_z, time.perf_counter())
            audios.append(audio_i)
            if want_z:
                zs.append(z_i)
            for k in ("frontend", "dispatch", "sync"):
                agg[k] += t_i[k]
            agg["frame_bucket"] = max(agg["frame_bucket"],
                                      t_i["frame_bucket"])
        audio = (np.concatenate(audios) if audios
                 else np.zeros(0, np.float32))
        elapsed = time.perf_counter() - t_start
        timings = {
            "total": elapsed,
            "audio_seconds": len(audio) / self.sampling_rate,
            "rtf": elapsed / max(len(audio) / self.sampling_rate, 1e-9),
            "pieces": len(pieces),
            **agg,
        }
        z = (np.concatenate(zs, axis=0) if want_z and zs else None)
        return audio, z, timings

    # ------------------------------------------------------------------
    # latents, then chunked decode
    # ------------------------------------------------------------------
    def prepare_shared_latents(
        self,
        text: str,
        sid: Optional[int] = None,
        noise_scale: float = 0.667,
        length_scale: float = 1.0,
        noise_scale_w: float = 0.8,
        cleaned: Optional[bool] = None,
        seed: Optional[int] = None,
        return_durations: bool = False,
    ):
        """One latents pass -> (z [y_len, C], y_len, sid), plus the
        per-token frame durations w [T_x] when ``return_durations``."""
        ids = self.text_to_ids(text, cleaned)
        x, x_lengths = self._pad_ids_cached(ids)
        sid_arr = self._sid_rows(1, sid)
        gen, w_eps = self._draws(x.shape, seed)
        bucket = self._frames_bucket(x, x_lengths, sid_arr, length_scale,
                                     noise_scale_w, w_eps)
        retry_ns = None  # the start of a redo at a larger bucket
        while True:
            z, y_lengths, w = self._latents(
                x, x_lengths, sid_arr, noise_scale, length_scale,
                noise_scale_w, bucket, gen, w_eps)
            fetch = [z[0], y_lengths]
            if return_durations:
                fetch.append(w[0])
            host = self._fetch(fetch)()
            if retry_ns is not None:
                record_span("synth.retry", retry_ns, now_ns())
            y_len = int(host[1][0])
            if y_len < bucket or bucket >= self.MAX_FRAMES:
                break
            retry_ns = now_ns()
            bucket = self._frame_bucket_capped(int(bucket * 3 / 2))
            if seed is not None:
                gen, w_eps = self._draws(x.shape, seed)
        z = host[0][:y_len]
        if return_durations:
            return z, y_len, sid, host[2][: len(ids)]  # w: [T_x] frames
        return z, y_len, sid

    def phrase_frame_boundaries(
        self,
        text: str,
        w: np.ndarray,
        cleaned: Optional[bool] = None,
        boundary_symbols: Optional[set] = None,
    ) -> List[int]:
        """Frame indices of phrase boundaries (pause / punctuation
        symbols in the ids), from the durations w of
        `prepare_shared_latents(..., return_durations=True)`."""
        ids = self.text_to_ids(text, cleaned)
        symbols = get_symbols(self.data_cfg.text_module)
        if boundary_symbols is None:
            boundary_symbols = _BOUNDARY_SYMBOLS
        cum = np.cumsum(np.asarray(w, np.float64))
        total = int(round(cum[-1])) if len(cum) else 0
        bounds = sorted({
            int(round(cum[i]))
            for i in range(min(len(ids), len(cum)))
            if symbols[ids[i]] in boundary_symbols
        })
        return [b for b in bounds if 0 < b < total]

    def synthesize_by_phrases(
        self,
        text: str,
        sid: Optional[int] = None,
        **kwargs,
    ) -> List[np.ndarray]:
        """One latents pass, then each phrase segment of z decoded on its
        own."""
        z, y_len, sid, w = self.prepare_shared_latents(
            text, sid, return_durations=True, **kwargs
        )
        bounds = self.phrase_frame_boundaries(
            text, w, cleaned=kwargs.get("cleaned")
        )
        edges = [0] + bounds + [y_len]
        return [
            self.infer_z_only(z[lo:hi], sid)
            for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo
        ]

    @staticmethod
    def _best_shift(a: np.ndarray, b: np.ndarray, max_shift: int,
                    lo: Optional[int] = None,
                    hi: Optional[int] = None) -> int:
        """Cross-correlation shift search between two overlap windows,
        over the feasible shifts [lo, hi] only."""
        lo = -max_shift if lo is None else max(-max_shift, lo)
        hi = max_shift if hi is None else min(max_shift, hi)
        best, best_c = 0, -np.inf
        norm_a = a - a.mean()
        for s in range(lo, hi + 1):
            if s >= 0:
                x, y = norm_a[s:], b[: len(b) - s]
            else:
                x, y = norm_a[: len(a) + s], b[-s:]
            if len(x) < 8:
                continue
            c = float(np.dot(x, y - y.mean()))
            if c > best_c:
                best, best_c = s, c
        return best

    def _stack_windows(self, plan: List[Tuple[int, int, int]],
                       z: np.ndarray, win_frames: int,
                       rows: int) -> np.ndarray:
        """Zero-padded chunk windows [rows, win_frames, zdim] for the
        given plan entries (rows >= len(plan); extra rows stay zero)."""
        windows = np.zeros((rows, win_frames, z.shape[-1]), np.float32)
        for i, (pos, lo, hi) in enumerate(plan):
            windows[i, : hi - lo] = z[lo:hi]
        return windows

    def _chunk_plan(self, t_total: int, chunk_frames: int,
                    overlap_frames: int) -> List[Tuple[int, int, int]]:
        """Chunk windows (pos, lo, hi): body starts at frame `pos`, the
        decoded window covers z[lo:hi] (body + leading/trailing overlap)."""
        plan: List[Tuple[int, int, int]] = []
        pos = 0
        while pos < t_total:
            plan.append((pos,
                         max(0, pos - overlap_frames),
                         min(t_total, pos + chunk_frames + overlap_frames)))
            pos += chunk_frames
        return plan

    def _chunk_plan_growing(self, t_total: int, first_chunk: int,
                            overlap_frames: int,
                            max_chunk: int) -> List[Tuple[int, int, int]]:
        """Chunk plan with doubling body sizes (first_chunk, 2x, ...,
        capped at max_chunk); an entry's body is the next entry's pos -
        pos."""
        plan: List[Tuple[int, int, int]] = []
        pos, size = 0, first_chunk
        while pos < t_total:
            plan.append((pos,
                         max(0, pos - overlap_frames),
                         min(t_total, pos + size + overlap_frames)))
            pos += size
            size = min(size * 2, max_chunk)
        return plan

    def stream_from_latents(
        self,
        z: np.ndarray,
        sid: Optional[int] = None,
        chunk_frames: int = 64,
        overlap_frames: int = 8,
        xcorr_align: bool = False,
        max_shift: int = 32,
        grow_chunks: bool = True,
        max_chunk_frames: int = 512,
    ) -> Iterator[np.ndarray]:
        """Decode z chunk by chunk, joined by a waveform overlap-add
        crossfade (optionally with a cross-correlation shift search at
        each join). grow_chunks: the first body stays `chunk_frames` (time
        to first audio) and each later one doubles up to
        `max_chunk_frames`. Chunk i+1 is queued before chunk i is
        waited for (module docstring)."""
        t_total = z.shape[0]
        if grow_chunks:
            plan = self._chunk_plan_growing(t_total, chunk_frames,
                                            overlap_frames, max_chunk_frames)
        else:
            plan = self._chunk_plan(t_total, chunk_frames, overlap_frames)
        if not plan:
            return

        def dispatch(i: int):
            pos = plan[i][0]
            nxt = plan[i + 1][0] if i + 1 < len(plan) else t_total
            win = (nxt - pos) + 2 * overlap_frames
            window = self._stack_windows(plan[i: i + 1], z, win, 1)
            return self._fetch([self._decode_pcm(
                self._latents_to_device(window), sid)[0]])

        def wavs():
            pending = dispatch(0)
            for i in range(len(plan)):
                nxt = dispatch(i + 1) if i + 1 < len(plan) else None
                wav = pending()[0].astype(np.float32) / 32767.0
                pending = nxt
                yield wav

        yield from self._ola_join(plan, wavs(), t_total,
                                  overlap_frames, xcorr_align, max_shift)

    def _ola_join(
        self,
        plan: List[Tuple[int, int, int]],
        wavs: Iterator[np.ndarray],
        t_total: int,
        overlap_frames: int,
        xcorr_align: bool,
        max_shift: int,
    ) -> Iterator[np.ndarray]:
        """Waveform overlap-add crossfade join over per-chunk decodes
        (`wavs` yields the decoded window of each plan entry; an entry's
        body length is the next entry's pos - pos)."""
        spf = self.hop_length
        ov_samps = overlap_frames * spf
        fade_in = np.linspace(0.0, 1.0, ov_samps, dtype=np.float32)
        fade_out = 1.0 - fade_in

        prev_tail: Optional[np.ndarray] = None
        for idx, ((pos, lo, hi), wav) in enumerate(zip(plan, wavs)):
            body_frames = (plan[idx + 1][0] if idx + 1 < len(plan)
                           else t_total) - pos
            wav = wav[: (hi - lo) * spf]
            # valid region of this chunk inside `wav`
            start = (pos - lo) * spf
            end = min(start + body_frames * spf, len(wav))
            if (xcorr_align and prev_tail is not None
                    and start >= ov_samps and len(prev_tail) == ov_samps):
                # shift the whole chunk window (not just the overlap) so
                # the aligned overlap stays contiguous with the body,
                # clamped to the decoded window
                s = self._best_shift(
                    prev_tail, wav[start - ov_samps: start],
                    min(max_shift, ov_samps // 4),
                    lo=end - len(wav), hi=start - ov_samps,
                )
                s = int(np.clip(s, end - len(wav), start - ov_samps))
                start -= s
                end -= s
            body = wav[start:end]
            head_ov = wav[max(0, start - ov_samps): start]
            if prev_tail is not None and len(head_ov) == ov_samps and len(
                prev_tail
            ) == ov_samps:
                yield prev_tail * fade_out + head_ov * fade_in
            elif prev_tail is not None:
                yield prev_tail
            # hold back our own tail for the next chunk's crossfade
            # (ov_samps == 0 butt-joins: body[:-0] would be empty)
            tail_sz = min(ov_samps, len(body))
            if (ov_samps > 0 and pos + body_frames < t_total
                    and tail_sz == ov_samps):
                yield body[:-ov_samps] if len(body) > ov_samps else \
                    body[:0]
                prev_tail = body[-ov_samps:]
            else:
                yield body
                prev_tail = None
        if prev_tail is not None:
            yield prev_tail

    def synthesize_from_shared_latents(
        self, z: np.ndarray, sid: Optional[int] = None, **kwargs
    ) -> np.ndarray:
        """Concatenated `stream_from_latents`."""
        chunks = list(self.stream_from_latents(z, sid, **kwargs))
        if not chunks:
            return np.zeros((0,), np.float32)
        return np.concatenate(chunks)

    def decode_chunks_batched(
        self,
        z: np.ndarray,
        sid: Optional[int] = None,
        chunk_frames: int = 64,
        overlap_frames: int = 8,
        xcorr_align: bool = False,
        max_shift: int = 32,
    ) -> np.ndarray:
        """All chunk windows of one utterance decoded as one batch (padded
        to a batch bucket, split over the mesh), then the same join as
        `stream_from_latents` with a uniform plan."""
        t_total = z.shape[0]
        plan = self._chunk_plan(t_total, chunk_frames, overlap_frames)
        if not plan:
            return np.zeros((0,), np.float32)
        w = chunk_frames + 2 * overlap_frames
        n = len(plan)
        windows = self._stack_windows(plan, z, w, self._batch_bucket(n))
        # the padded rows come back too: one copy, no slicing launch
        wav = np.concatenate(self._fetch([
            self._decode_pcm(part, sid, i) for i, part in
            enumerate(self._shard(self._latents_to_device(windows)))])())
        wav = wav.astype(np.float32) / 32767.0
        spf = self.hop_length
        return np.concatenate(list(self._ola_join(
            plan, iter([wav[i] for i in range(n)]), t_total, overlap_frames,
            xcorr_align, max_shift,
        ))).astype(np.float32)[: t_total * spf]

    # ------------------------------------------------------------------
    # spectrogram-domain chunk join
    # ------------------------------------------------------------------
    @staticmethod
    def _best_frame_shift(a: np.ndarray, b: np.ndarray,
                          max_shift: int,
                          lo: Optional[int] = None,
                          hi: Optional[int] = None) -> int:
        """Frame-domain cross-correlation shift search between two overlap
        windows of magnitude frames [F, ...]: log-magnitude, centred per
        channel over time, zero-padded lags, feasible shifts [lo, hi]
        only. Returns s such that b[t+s] aligns with a[t]."""
        af = np.log(a.reshape(len(a), -1) + 1e-6)
        bf = np.log(b.reshape(len(b), -1) + 1e-6)
        af = af - af.mean(axis=0, keepdims=True)
        bf = bf - bf.mean(axis=0, keepdims=True)
        pad = np.pad(bf, ((max_shift, max_shift), (0, 0)))
        n = len(af)
        lo = -max_shift if lo is None else max(-max_shift, lo)
        hi = max_shift if hi is None else min(max_shift, hi)
        if hi < lo:
            return 0
        ks = range(lo + max_shift, hi + max_shift + 1)
        scores = [float(np.sum(pad[k:k + n] * af)) for k in ks]
        return int(np.argmax(scores)) + lo

    def decode_spec_join(
        self,
        z: np.ndarray,
        sid: Optional[int] = None,
        chunk_frames: int = 64,
        overlap_frames: int = 8,
        frame_xcorr: bool = False,
        max_shift: int = 4,
        batched: bool = False,
    ) -> np.ndarray:
        """Chunked decode joined in the spectrogram domain: each chunk is
        decoded to its (spec, phase) head output, overlapping frames are
        crossfaded as complex spectra, and the head's tail (iSTFT, then
        PQMF or the synthesis conv for the sub-band heads) runs once over
        the joined spectrogram. ``frame_xcorr`` adds a frame-shift search
        at each join; ``batched`` decodes all chunks as one batch (split
        over the mesh), else chunk by chunk in a one-deep pipeline."""
        self._require_spectrogram("decode_spec_join")
        t_total = z.shape[0]
        if t_total == 0:
            return np.zeros((0,), np.float32)
        up = math.prod(self.cfg.upsample_rates)
        win_frames = chunk_frames + 2 * overlap_frames
        ov_f = overlap_frames * up
        fade_in = np.linspace(0.0, 1.0, ov_f, dtype=np.float32)

        plan = self._chunk_plan(t_total, chunk_frames, overlap_frames)

        if batched:
            n = len(plan)
            windows = self._stack_windows(plan, z, win_frames,
                                          self._batch_bucket(n))
            parts = [self._decode_spec(part, sid, i) for i, part in
                     enumerate(self._shard(self._latents_to_device(windows)))]
            host = self._fetch([t for part in parts for t in part])()
            spec_all = np.concatenate(host[0::2])
            phase_all = np.concatenate(host[1::2])

            def cspecs():
                for i in range(n):
                    yield spec_all[i] * np.exp(1j * phase_all[i])
        else:
            def dispatch(i: int):
                window = self._stack_windows(plan[i: i + 1], z,
                                             win_frames, 1)
                spec, phase = self._decode_spec(
                    self._latents_to_device(window), sid)
                return self._fetch([spec[0], phase[0]])

            def cspecs():
                pending = dispatch(0)
                for i in range(len(plan)):
                    nxt = dispatch(i + 1) if i + 1 < len(plan) else None
                    spec, phase = pending()
                    yield spec * np.exp(1j * phase)
                    pending = nxt

        joined: List[np.ndarray] = []  # complex spectrum frames [F, ...]
        prev_tail: Optional[np.ndarray] = None
        for (pos, lo, hi), cspec in zip(plan, cspecs()):
            start_f = (pos - lo) * up
            end_f = start_f + min(chunk_frames, t_total - pos) * up
            valid_f = (hi - lo) * up  # frames actually decoded from z
            if frame_xcorr and prev_tail is not None and start_f >= ov_f:
                # shift the whole remaining chunk by s (clamped to the
                # decoded frames) so the overlap stays contiguous with
                # the body and the length is kept
                s = self._best_frame_shift(
                    np.abs(prev_tail),
                    np.abs(cspec[start_f - ov_f: start_f]), max_shift,
                    lo=-(start_f - ov_f), hi=valid_f - end_f)
                s = int(np.clip(s, -(start_f - ov_f), valid_f - end_f))
                start_f += s
                end_f += s
            body = cspec[start_f:end_f]
            head_ov = cspec[max(0, start_f - ov_f): start_f]
            if prev_tail is not None and len(head_ov) == ov_f:
                fade = fade_in.reshape((ov_f,) + (1,) * (body.ndim - 1))
                joined.append(prev_tail * (1 - fade) + head_ov * fade)
            elif prev_tail is not None:
                joined.append(prev_tail)
            is_last = pos + chunk_frames >= t_total
            # ov_f == 0 butt-joins the frames (body[:-0] would be empty)
            if ov_f > 0 and not is_last and len(body) > ov_f:
                joined.append(body[:-ov_f])
                prev_tail = body[-ov_f:]
            else:
                joined.append(body)
                prev_tail = None
        if prev_tail is not None:
            joined.append(prev_tail)
        cfull = np.concatenate(joined, axis=0)  # [F_total, ...]
        f_total = len(cfull)

        # the center=True iSTFT yields (bucket - 1) * hop samples, so the
        # bucket covers f_total + 1 frames to reach t_total * hop
        bucket = _next_bucket(f_total + 1, (), granule=16 * up)
        pad_shape = (1, bucket) + cfull.shape[1:]
        spec_p = np.zeros(pad_shape, np.float32)
        phase_p = np.zeros(pad_shape, np.float32)
        spec_p[0, :f_total] = np.abs(cfull)
        phase_p[0, :f_total] = np.angle(cfull)
        tail = self._program("spec_tail", self._to_device(spec_p),
                             self._to_device(phase_p))
        wav = self._fetch([tail[0]])()[0]
        return wav[: t_total * self.hop_length].astype(np.float32)

    def infer_z_only(self, z: np.ndarray, sid: Optional[int] = None
                     ) -> np.ndarray:
        """Decoder only on a whole z [T, C], at its frame bucket."""
        bucket = _next_bucket(z.shape[0], self.FRAME_BUCKETS)
        zp = np.zeros((1, bucket, z.shape[-1]), np.float32)
        zp[0, : z.shape[0]] = z
        wav = self._fetch([self._decode_pcm(self._latents_to_device(zp),
                                            sid)[0]])()[0]
        wav = wav.astype(np.float32) / 32767.0
        return wav[: z.shape[0] * self.hop_length]

    # ------------------------------------------------------------------
    # batched synthesis: many utterances per decode
    # ------------------------------------------------------------------
    def _batch_bucket(self, n: int) -> int:
        """Batch count -> batch bucket, rounded up to a multiple of the
        mesh's devices (granule 8 beyond the table: the padded rows are
        decoded and fetched)."""
        n_dev = len(self._replicas)
        nb = _next_bucket(max(n, n_dev), self.BATCH_BUCKETS, granule=8)
        if nb % n_dev:
            nb += n_dev - nb % n_dev
        return nb

    def synthesize_batch(
        self,
        texts: List[str],
        sids: Optional[List[Optional[int]]] = None,
        noise_scale: float = 0.667,
        length_scale: float = 1.0,
        noise_scale_w: float = 0.8,
        cleaned: Optional[bool] = None,
        seed: int = 0,
        out_sample_rate: Optional[int] = None,
    ) -> Tuple[List[np.ndarray], Dict[str, float]]:
        """Synthesize a list of utterances as one batch, padded to (batch,
        text, frame) buckets and split over the mesh, row i as speaker
        `sids[i]` (`None`: 0).
        Returns per-utterance trimmed audio and aggregate timings.
        `out_sample_rate` resamples on the device (`resample_poly_torch`,
        up or down); timings count audio seconds at the output rate."""
        t0 = time.perf_counter()
        ids_list = [self.text_to_ids(t, cleaned) for t in texts]
        n = len(ids_list)
        if n == 0:
            return [], {"total": 0.0, "audio_seconds": 0.0, "rtf": 0.0,
                        "utterances_per_sec": 0.0}
        nb = self._batch_bucket(n)
        t_x = _next_bucket(max(len(i) for i in ids_list), self.TEXT_BUCKETS)
        x = np.zeros((nb, t_x), np.int64)
        x_lengths = np.ones((nb,), np.int64)
        for i, ids in enumerate(ids_list):
            x[i, : len(ids)] = ids
            x_lengths[i] = len(ids)
        sid_arr = None
        if self.cfg.n_speakers > 0:
            sid_arr = np.zeros((nb,), np.int64)
            for i, s in enumerate((sids or [])[:n]):
                sid_arr[i] = 0 if s is None else int(s)
        # the batch's draws on the first device, split by row below
        gen, w_eps = self._draws((nb, t_x), seed)
        parts = self._shard({
            "x": self._to_device(x), "x_lengths": self._to_device(x_lengths),
            "sid": None if sid_arr is None else self._to_device(sid_arr),
            "w_eps": w_eps})
        with span("synth.probe"):
            frames = [self._predict_frames(p["x"], p["x_lengths"],
                                           p["sid"], length_scale,
                                           noise_scale_w, p["w_eps"], i)
                      for i, p in enumerate(parts)]
            # capped like the single-request path: one out-of-distribution
            # row must not size the whole batch's decode without bound
            bucket = self._frame_bucket_capped(
                max(int(f.max()) for f in frames))
        out_sr = (None if out_sample_rate in (None, self.sampling_rate)
                  else int(out_sample_rate))
        with span("synth.dispatch"):
            # the prior's noise after w_eps, as `Synthesizer.infer` draws
            # it (the single-request path's dispatch draws it too)
            eps = self._shard(self._eps(gen, nb, bucket))
            fetch = []
            for i, (p, e) in enumerate(zip(parts, eps)):
                # every device's work is queued before the first copy back
                fetch += self._infer(p["x"], p["x_lengths"], p["sid"],
                                     noise_scale, length_scale,
                                     noise_scale_w, bucket, gen, p["w_eps"],
                                     out_sr, eps=e, replica=i)
            pending = self._fetch(fetch)
        host = pending()
        pcm_host = np.concatenate(host[0::2])
        y_lens = np.concatenate(host[1::2])
        if recording():
            record_count("synth.frames", (
                nb, bucket, tuple(int(v) for v in y_lens[:n]),
                tuple(len(i) for i in ids_list)))
        wavs = pcm_host.astype(np.float32) / 32767.0
        sr_out = out_sr or self.sampling_rate
        if out_sr is None:
            n_samp = [int(y_lens[i]) * self.hop_length for i in range(n)]
        else:
            # trimmed length scales with the rational rate ratio
            n_samp = [
                -(-int(y_lens[i]) * self.hop_length * out_sr
                  // self.sampling_rate)
                for i in range(n)
            ]
        audios = [wavs[i, : n_samp[i]] for i in range(n)]
        elapsed = time.perf_counter() - t0
        total_audio = sum(len(a) for a in audios) / sr_out
        return audios, {
            "total": elapsed,
            "audio_seconds": total_audio,
            "rtf": elapsed / max(total_audio, 1e-9),
            "utterances_per_sec": n / elapsed,
        }

    # ------------------------------------------------------------------
    # staged timings
    # ------------------------------------------------------------------
    def synthesize_staged(self, text: str, sid: Optional[int] = None,
                          **kwargs) -> Tuple[np.ndarray, Dict[str, float]]:
        """Synthesis with per-stage timings: `latents` (text encoder,
        duration predictor, alignment, flow; z fetched to the host) and
        `waveform_decoder`."""
        t0 = time.perf_counter()
        z, y_len, sid = self.prepare_shared_latents(text, sid, **kwargs)
        t1 = time.perf_counter()
        audio = self.infer_z_only(z, sid)
        t2 = time.perf_counter()
        timings = {
            "latents": t1 - t0,
            "waveform_decoder": t2 - t1,
            "total": t2 - t0,
            "rtf": (t2 - t0) / max(len(audio) / self.sampling_rate, 1e-9),
        }
        return audio, timings
