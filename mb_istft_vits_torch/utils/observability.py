"""Observability: TensorBoard summaries, the spectrogram and alignment
plots, the trainer's anomaly mode and profiler traces (counterpart of
`mb_istft_vits_tpu/utils/observability.py`; reference `utils.py:63-136`).

The writer is a `tensorboardX.SummaryWriter` made by the caller, and
matplotlib is imported by the plots themselves, so neither is needed to
import this module.
"""

from __future__ import annotations

import contextlib
import io
import wave
from typing import Dict, Optional

import numpy as np

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


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block with `torch.profiler` (host ops, and the card's
    kernels when CUDA is available) and write a Chrome trace
    (`*.pt.trace.json`, viewable in Perfetto or TensorBoard) into
    `log_dir` when it ends: the JAX package's `jax.profiler` trace.
    Yields the profiler, whose `key_averages()` can be read after the
    block."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
