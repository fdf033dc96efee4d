"""Incremental streaming TTS with cancellation (the port's copy of
`mb_istft_vits_tpu/serve/streaming.py`).

Behavior contract: reference `tts_vits.py:24-252`, a RabbitMQ "incremental
unit" module for the Remdis dialogue framework with three threads
(listen / synthesize / send), REVOKE cancellation, resampling,
normalize -> int16 -> base64 PCM chunks emitted at a fixed send interval.

The core engine is transport-agnostic: `IncrementalTTS` runs the
pipeline over queues and emits chunks to a callback; a thin RabbitMQ
adapter (`RemdisTTSModule`) sits behind an optional `pika` import.
Chunking is 20 ms PCM frames like the reference. The synthesis module is
called from the synthesis thread only.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np

from mb_istft_vits_torch.dsp.resample import PolyphaseStreamResampler
from mb_istft_vits_torch.utils.audio import float_to_int16


@dataclasses.dataclass
class TTSRequest:
    text: str
    utterance_id: str = ""
    sid: Optional[int] = None
    noise_scale: float = 0.667
    length_scale: float = 1.0
    noise_scale_w: float = 0.8
    cleaned: Optional[bool] = None


def resample_linear(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear resampler (replaces the reference's librosa.resample,
    tts_vits.py semantics; linear is adequate for 16k->48k playback)."""
    if sr_in == sr_out:
        return audio
    n_out = int(round(len(audio) * sr_out / sr_in))
    x_out = np.linspace(0.0, len(audio) - 1, n_out)
    return np.interp(x_out, np.arange(len(audio)), audio).astype(np.float32)


class StreamResampler:
    """Linear resampler that carries fractional phase across chunks, so
    the output sample grid is continuous over a whole utterance (chunk-
    independent resampling restarts the grid at every chunk boundary —
    periodic timing jitter and interpolation seams)."""

    def __init__(self, sr_in: int, sr_out: int):
        self.step = sr_in / sr_out  # input samples per output sample
        self.t = 0.0     # absolute input-time of the next output sample
        self.n_in = 0    # input samples consumed so far
        self.prev = np.zeros(0, np.float32)  # last input sample (overlap)

    def __call__(self, chunk: np.ndarray) -> np.ndarray:
        if self.step == 1.0:
            return chunk
        x = np.concatenate([self.prev, chunk.astype(np.float32)])
        base = self.n_in - len(self.prev)  # absolute index of x[0]
        # produce outputs with t in [base, base + len(x) - 1]
        last = base + len(x) - 1
        ts = []
        while self.t <= last + 1e-9:
            ts.append(self.t)
            self.t += self.step
        y = (np.interp(np.asarray(ts) - base, np.arange(len(x)), x)
             .astype(np.float32) if ts else np.zeros(0, np.float32))
        self.n_in += len(chunk)
        self.prev = x[-1:]
        return y


def to_int16(audio: np.ndarray) -> np.ndarray:
    return float_to_int16(audio)


class IncrementalTTS:
    """Three-stage streaming pipeline: text queue → synthesis thread →
    chunk queue → sender thread → `on_chunk` callback.

    REVOKE semantics (reference tts_vits.py): `revoke(utterance_id)` drops
    queued text and flushes pending audio for that utterance.
    """

    def __init__(
        self,
        synthesis_module,
        on_chunk: Callable[[str, bytes], None],
        out_sample_rate: Optional[int] = None,
        chunk_ms: int = 20,
        send_interval_ms: int = 20,
        base64_encode: bool = True,
        resample_quality: str = "fast",
    ):
        self.module = synthesis_module
        self.on_chunk = on_chunk
        self.sr_in = synthesis_module.sampling_rate
        self.sr_out = out_sample_rate or self.sr_in
        self.chunk_samples = int(self.sr_out * chunk_ms / 1000)
        self.send_interval = send_interval_ms / 1000.0
        self.base64_encode = base64_encode
        # "fast"/"best": windowed-sinc polyphase (librosa.resample-quality,
        # the reference's tts_vits.py:182-185 path); "linear": first-order
        if resample_quality not in ("linear", "fast", "best"):
            raise ValueError(f"unknown resample_quality {resample_quality!r}")
        self.resample_quality = resample_quality

        self._text_q: "queue.Queue[Optional[TTSRequest]]" = queue.Queue()
        self._audio_q: "queue.Queue[tuple]" = queue.Queue()
        # insertion-ordered, bounded: a long-running service must not leak
        # revoked ids (and an unbounded set would permanently mute any
        # recycled utterance id)
        self._revoked: "dict[str, None]" = {}
        self._revoked_cap = 1024
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []
        self.on_error: Optional[Callable[[str, Exception], None]] = None

    # -- public API ------------------------------------------------------
    def submit(self, request: TTSRequest) -> None:
        self._text_q.put(request)

    def revoke(self, utterance_id: str) -> None:
        with self._lock:
            self._revoked[utterance_id] = None
            while len(self._revoked) > self._revoked_cap:
                self._revoked.pop(next(iter(self._revoked)))

    def start(self) -> None:
        self._threads = [
            threading.Thread(target=self._synthesize_loop, daemon=True),
            threading.Thread(target=self._send_loop, daemon=True),
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        self._text_q.put(None)
        for t in self._threads:
            t.join(timeout=5)

    # -- pipeline stages ---------------------------------------------------
    def _is_revoked(self, uid: str) -> bool:
        with self._lock:
            return uid in self._revoked

    def _revoke_done(self, uid: str) -> None:
        """The revoked utterance's lifecycle is over (its end marker or
        queued text has been consumed) — release the id. Tying eviction
        to completion (not the insertion-order cap alone) means a burst
        of later revokes can't evict a still-pending one and un-revoke
        it; the cap stays as a backstop for ids that were revoked but
        never submitted."""
        with self._lock:
            self._revoked.pop(uid, None)

    def _synthesize_loop(self) -> None:
        while not self._stop.is_set():
            req = self._text_q.get()
            if req is None:
                break
            if self._is_revoked(req.utterance_id):
                # queued text dropped before synthesis; nothing of this
                # utterance can reach the audio queue anymore
                self._revoke_done(req.utterance_id)
                continue
            try:
                # latents once, decode incrementally (streaming chunks
                # start flowing before the full utterance is decoded)
                z, y_len, sid = self.module.prepare_shared_latents(
                    req.text, sid=req.sid, noise_scale=req.noise_scale,
                    length_scale=req.length_scale,
                    noise_scale_w=req.noise_scale_w, cleaned=req.cleaned,
                )
                if self.resample_quality == "linear":
                    resample = StreamResampler(self.sr_in, self.sr_out)
                else:
                    resample = PolyphaseStreamResampler(
                        self.sr_in, self.sr_out, self.resample_quality)
                revoked_mid = False
                for wav in self.module.stream_from_latents(z, sid=sid):
                    if self._is_revoked(req.utterance_id):
                        revoked_mid = True
                        break
                    if len(wav) == 0:
                        continue
                    audio = resample(wav)
                    if len(audio):
                        self._audio_q.put((req.utterance_id, audio))
                if not revoked_mid and hasattr(resample, "flush"):
                    audio = resample.flush()
                    if len(audio):
                        self._audio_q.put((req.utterance_id, audio))
            except Exception as e:  # keep the service alive: one bad
                # utterance must not kill the daemon thread and hang
                # every later request
                if self.on_error is not None:
                    self.on_error(req.utterance_id, e)
                else:
                    logging.getLogger(__name__).exception(
                        "synthesis failed for utterance %r",
                        req.utterance_id,
                    )
            finally:
                self._audio_q.put((req.utterance_id, None))  # end marker

    def _send_loop(self) -> None:
        buf = np.zeros(0, np.float32)
        uid = ""
        while not self._stop.is_set():
            try:
                uid_new, audio = self._audio_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if self._is_revoked(uid_new):
                buf = np.zeros(0, np.float32)
                if audio is None:  # end marker: lifecycle over
                    self._revoke_done(uid_new)
                continue
            uid = uid_new
            if audio is not None:
                buf = np.concatenate([buf, audio])
            flush = audio is None
            # the loop condition itself drains the sub-chunk remainder on
            # flush (chunk = whatever is left), so every chunk — tail
            # included — goes through the same encode + pacing path
            while len(buf) >= self.chunk_samples or (flush and len(buf)):
                # re-check every paced iteration: REVOKE (or stop) must
                # flush the remaining buffered audio immediately, not
                # after the current decode chunk finishes pacing out —
                # with 20 ms pacing a 64-frame decode chunk would
                # otherwise keep the bot speaking ~0.75 s past the
                # barge-in (reference contract: revoke flushes pending
                # audio, tts_vits.py REVOKE handling)
                if self._stop.is_set() or self._is_revoked(uid):
                    buf = np.zeros(0, np.float32)
                    break
                chunk, buf = (buf[: self.chunk_samples],
                              buf[self.chunk_samples :])
                pcm = to_int16(chunk).tobytes()
                payload = (base64.b64encode(pcm) if self.base64_encode
                           else pcm)
                try:
                    self.on_chunk(uid, payload)
                except Exception as e:
                    # the sender daemon must survive a failing transport
                    # callback — otherwise audio queues forever and the
                    # engine is silently mute. Drop this utterance's
                    # remaining audio and keep serving.
                    buf = np.zeros(0, np.float32)
                    if self.on_error is not None:
                        self.on_error(uid, e)
                    else:
                        logging.getLogger(__name__).exception(
                            "chunk delivery failed for utterance %r", uid)
                    break
                if self.send_interval:
                    time.sleep(self.send_interval)


class RemdisTTSModule:
    """RabbitMQ adapter mirroring the reference Remdis module surface
    (tts_vits.py:24-252). Requires the optional `pika` package."""

    def __init__(self, synthesis_module, host: str = "localhost",
                 in_exchange: str = "dialogue", out_exchange: str = "tts",
                 out_sample_rate: Optional[int] = None, chunk_ms: int = 20,
                 send_interval_ms: int = 20):
        try:
            import pika  # type: ignore # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "RemdisTTSModule needs the optional 'pika' package; use "
                "IncrementalTTS with your own transport instead."
            ) from e
        self.host = host
        self.in_exchange = in_exchange
        self.out_exchange = out_exchange
        self._pub_conn = None
        self._pub_ch = None
        # out_sample_rate: the reference resamples to the playback rate
        # (librosa.resample in tts_vits.py) — expose it here or the
        # engine's resampler is unreachable through this adapter
        self.engine = IncrementalTTS(
            synthesis_module, self._publish,
            out_sample_rate=out_sample_rate, chunk_ms=chunk_ms,
            send_interval_ms=send_interval_ms,
        )

    def _publish_channel(self):
        """One long-lived publisher connection (the reference keeps a
        single connection too; a TCP+AMQP handshake per 20 ms chunk
        cannot keep up with realtime)."""
        import pika  # type: ignore

        if self._pub_ch is None or not self._pub_conn.is_open:
            self._pub_conn = pika.BlockingConnection(
                pika.ConnectionParameters(host=self.host)
            )
            self._pub_ch = self._pub_conn.channel()
            # declare before publishing: on a fresh broker an undeclared
            # exchange 404-closes the channel on first basic_publish
            self._pub_ch.exchange_declare(exchange=self.out_exchange,
                                          exchange_type="fanout")
        return self._pub_ch

    def _publish(self, uid: str, payload: bytes) -> None:
        body = json.dumps({"id": uid, "chunk": payload.decode()})
        try:
            self._publish_channel().basic_publish(
                exchange=self.out_exchange, routing_key="", body=body)
        except Exception:
            # broker hiccup: reconnect once, then let the error surface
            self._pub_ch = None
            self._publish_channel().basic_publish(
                exchange=self.out_exchange, routing_key="", body=body)

    def run(self) -> None:
        import pika  # type: ignore

        self.engine.start()
        conn = pika.BlockingConnection(
            pika.ConnectionParameters(host=self.host)
        )
        ch = conn.channel()
        ch.exchange_declare(exchange=self.in_exchange, exchange_type="fanout")
        q = ch.queue_declare(queue="", exclusive=True).method.queue
        ch.queue_bind(exchange=self.in_exchange, queue=q)

        def cb(chan, method, properties, body):
            msg = json.loads(body)
            if msg.get("update_type") == "REVOKE":
                self.engine.revoke(msg.get("id", ""))
            else:
                self.engine.submit(TTSRequest(
                    text=msg.get("body", ""), utterance_id=msg.get("id", ""),
                ))

        ch.basic_consume(queue=q, on_message_callback=cb, auto_ack=True)
        ch.start_consuming()
