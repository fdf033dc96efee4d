"""Observability: TensorBoard summaries, the spectrogram and alignment
plots, the trainer's anomaly mode, profiler traces and the spans recorded
while a profiler runs (counterpart of
`mb_istft_vits_tpu/utils/observability.py`; reference `utils.py:63-136`).

The writer is a `tensorboardX.SummaryWriter` made by the caller, and
matplotlib is imported by the plots themselves, so neither is needed to
import this module.

Spans: `span(name)` times a block of host work on any thread, and
`record_span` a span whose start was stamped elsewhere (another thread).
They record only while a `torch.profiler` profile runs anywhere in the
process, and then into one bounded in-process log (`SPANS`), on the clock
of the profiler's host events, so a reader can lay them over the device
trace of the same window (`recorded_spans`). The log is not the
profiler's own record: a profiler that traces the CPU records the ranges
of the thread that started it, and the serving front end works on two
worker threads and is called from client threads. With no profiler,
`span` returns one shared null context and records nothing.

Counts: `record_count(name, values)` logs a tuple of numbers stamped on
the same clock, under the same rule (only while a profiler runs), into
a second log of the same kind (`COUNTS`, read by `recorded_counts`): the
serving module's `synth.frames`, each decode's rows and frames.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import socket
import threading
import time
import wave
from typing import Dict, List, Optional, Tuple

import numpy as np
from torch.autograd import profiler as _autograd_profiler

from mb_istft_vits_torch.utils.audio import float_to_int16


def encode_wav_bytes(audio: np.ndarray, sampling_rate: int) -> bytes:
    """float [-1, 1] mono -> 16-bit PCM WAV bytes (stdlib only)."""
    pcm16 = float_to_int16(np.asarray(audio).reshape(-1)).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sampling_rate)
        w.writeframes(pcm16.tobytes())
    return buf.getvalue()


def _add_audio(writer, tag: str, audio: np.ndarray, global_step: int,
               sampling_rate: int) -> None:
    """An audio summary without tensorboardX's soundfile dependency: the
    WAV encoded with the stdlib, the Summary proto written directly; the
    stock `add_audio` where that proto path is not available."""
    try:
        from tensorboardX.proto.summary_pb2 import Summary
    except ImportError:
        writer.add_audio(tag, np.asarray(audio), global_step, sampling_rate)
        return
    audio_proto = Summary.Audio(
        sample_rate=sampling_rate, num_channels=1,
        length_frames=len(np.asarray(audio).reshape(-1)),
        encoded_audio_string=encode_wav_bytes(audio, sampling_rate),
        content_type="audio/wav")
    writer.file_writer.add_summary(
        Summary(value=[Summary.Value(tag=tag, audio=audio_proto)]),
        global_step)


def summarize(writer, global_step: int, scalars: Optional[Dict] = None,
              histograms: Optional[Dict] = None,
              images: Optional[Dict] = None, audios: Optional[Dict] = None,
              audio_sampling_rate: int = 22050) -> None:
    """TensorBoard logging (reference utils.py:63-71); images are HWC
    uint8."""
    for k, v in (scalars or {}).items():
        writer.add_scalar(k, float(v), global_step)
    for k, v in (histograms or {}).items():
        writer.add_histogram(k, np.asarray(v), global_step)
    for k, v in (images or {}).items():
        writer.add_image(k, v, global_step, dataformats="HWC")
    for k, v in (audios or {}).items():
        _add_audio(writer, k, np.asarray(v), global_step,
                   audio_sampling_rate)


def _render_figure(fig) -> np.ndarray:
    fig.canvas.draw()
    data = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    return data.reshape(h, w, 4)[..., :3].copy()


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_spectrogram_to_numpy(spectrogram: np.ndarray) -> np.ndarray:
    """[n_mels, F] -> HWC uint8 image (reference utils.py:82-107)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(np.asarray(spectrogram), aspect="auto", origin="lower",
                   interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("Channels")
    plt.tight_layout()
    data = _render_figure(fig)
    plt.close(fig)
    return data


def plot_alignment_to_numpy(alignment: np.ndarray,
                            info: Optional[str] = None) -> np.ndarray:
    """[T_y, T_x] -> HWC uint8 image (reference utils.py:110-136)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(np.asarray(alignment).T, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    xlabel = "Decoder timestep"
    if info is not None:
        xlabel += "\n\n" + info
    plt.xlabel(xlabel)
    plt.ylabel("Encoder timestep")
    plt.tight_layout()
    data = _render_figure(fig)
    plt.close(fig)
    return data


def enable_nan_debugging() -> None:
    """The reference's always-on autograd anomaly mode
    (train_latest.py:40), which the JAX package's `--debug-nans` stands
    in for: a backward op that yields NaN raises, naming the forward op."""
    import torch

    torch.autograd.set_detect_anomaly(True)


# -- spans -------------------------------------------------------------------

# the stamps' clock: the one kineto puts the profiler's host events on
# (Unix time in ns); tests/test_torch_port_spans.py pins the two together
now_ns = time.time_ns

# a 30 s window of the serving benchmark at 80 requests a second records
# about 4,500 spans (a queue wait a request, five spans a decode); the log
# holds more than ten such windows
SPAN_LOG_SPANS = 1 << 16

Span = Tuple[str, int, int, int]  # (name, native thread id, start, end)

# the Chrome trace's row ids of the spans: above any Linux thread id
# (pid_max is at most 2**22), inside 32 bits
SPAN_ROW_BASE = 1 << 30


class SpanLog:
    """A bounded log of spans, safe to append from any thread. When full
    it drops its oldest span for each new one and counts the drops. The
    count log (`COUNTS`) is one too: its entries are spans of no length
    that carry their values after the end stamp."""

    def __init__(self, maxlen: int = SPAN_LOG_SPANS):
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=maxlen)
        self._lock = threading.Lock()
        self.dropped = 0
        self._dropped_end_ns = -1  # the latest end among the dropped

    def record(self, name: str, start_ns: int, end_ns: int,
               *values) -> None:
        # the thread's id as set at its start: `get_native_id()` is a
        # system call on every use
        item = (name, threading.current_thread().native_id, start_ns,
                end_ns, *values)
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
                self._dropped_end_ns = max(self._dropped_end_ns,
                                           self._spans[0][3])
            self._spans.append(item)

    def spans(self, t0_ns: int, t1_ns: int) -> Tuple[List[Span], int]:
        """(the spans that start in [t0_ns, t1_ns), sorted by start; the
        spans dropped so far if any of them ended at or after t0_ns,
        else 0)."""
        with self._lock:
            got = [s for s in self._spans if t0_ns <= s[2] < t1_ns]
            dropped = self.dropped if self._dropped_end_ns >= t0_ns else 0
        return sorted(got, key=lambda s: s[2]), dropped


SPANS = SpanLog()


class _Span:
    __slots__ = ("name", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> int:
        self.start = now_ns()
        return self.start

    def __exit__(self, *exc) -> bool:
        record_span(self.name, self.start, now_ns())
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the block as the span `name` while a
    profiler runs, and yields its start stamp (ns); otherwise one shared
    null context, which yields None."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def record_span(name: str, start_ns: int, end_ns: int) -> None:
    """Record the span `name` from `start_ns` to `end_ns` (`now_ns()`
    stamps) while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        SPANS.record(name, start_ns, end_ns)


def recorded_spans(t0_ns: int, t1_ns: int) -> Tuple[List[Span], int]:
    """(name, native thread id, start_ns, end_ns) of every logged span
    that starts in [t0_ns, t1_ns), and the count of spans the log dropped
    that may have been among them (0: the list is whole)."""
    return SPANS.spans(t0_ns, t1_ns)


# (name, stamp ns, values): `record_count`'s entries, as read back
Count = Tuple[str, int, tuple]

COUNTS = SpanLog()


def recording() -> bool:
    """Whether spans and counts are recorded now (a profiler runs): a
    caller whose values cost something to gather asks first."""
    return _autograd_profiler._is_profiler_enabled


def record_count(name: str, values) -> None:
    """Log `values` (a tuple of numbers, or of tuples of them) under
    `name`, stamped now, while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        stamp = now_ns()
        COUNTS.record(name, stamp, stamp, tuple(values))


def recorded_counts(t0_ns: int, t1_ns: int) -> Tuple[List[Count], int]:
    """(name, stamp_ns, values) of every logged count stamped in
    [t0_ns, t1_ns), and the count of entries the log dropped that may
    have been among them (0: the list is whole)."""
    got, dropped = COUNTS.spans(t0_ns, t1_ns)
    return [(name, stamp, values) for name, _, stamp, _, values in got], \
        dropped


def _span_events(spans: List[Span], base_ns: int, pid: int) -> List[dict]:
    """Chrome trace events of `spans`: complete events on rows of their
    own, one per recording thread (more where that thread's spans overlap
    without nesting, such as the queue waits a serving worker records
    for its callers), each row named after its thread."""
    events, rows = [], {}  # (thread, lane) -> (row id, open spans' ends)
    for name, tid, s, e in sorted(spans, key=lambda x: (x[2], -x[3])):
        lane = 0
        while True:
            row, open_ends = rows.setdefault(
                (tid, lane), (SPAN_ROW_BASE + len(rows), []))
            while open_ends and open_ends[-1] <= s:
                open_ends.pop()
            if not open_ends or e <= open_ends[-1]:
                break
            lane += 1
        open_ends.append(e)
        events.append({"ph": "X", "cat": "span", "name": name, "pid": pid,
                       "tid": row, "ts": (s - base_ns) / 1e3,
                       "dur": (e - s) / 1e3})
    for (tid, lane), (row, _) in rows.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": row, "args": {"name": f"spans of thread {tid}"
                                            + (f" ({lane})" if lane else "")}})
    return events


def _write_trace(prof, log_dir: str, t0_ns: int) -> None:
    """The profile's Chrome trace in `log_dir` (named as
    `tensorboard_trace_handler` names it), with the spans recorded since
    `t0_ns` added on the trace's own time base."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                        f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    spans, _ = recorded_spans(t0_ns, now_ns())
    if not spans:
        return
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    trace["traceEvents"] += _span_events(
        spans, trace.get("baseTimeNanoseconds", 0), os.getpid())
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block with `torch.profiler` (host ops, and the card's
    kernels when CUDA is available) and write a Chrome trace
    (`*.pt.trace.json`, viewable in Perfetto or TensorBoard) into
    `log_dir` when it ends: the JAX package's `jax.profiler` trace. The
    spans recorded during the block (`span`) are in it too, on rows of
    their own over the device's rows. Yields the profiler, whose
    `key_averages()` can be read after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = now_ns()
    with profile(activities=activities,
                 on_trace_ready=lambda p: _write_trace(p, log_dir, t0)
                 ) as prof:
        yield prof
