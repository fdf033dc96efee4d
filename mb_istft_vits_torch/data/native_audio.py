"""ctypes binding of the native loader core, `csrc/audio.cpp` (the port's
copy of `mb_istft_vits_tpu/data/native_audio.py`): a RIFF PCM16 / float32
mono wav reader and a radix-2 FFT linear spectrogram, OpenMP over frames.

The library is built with g++ at first use into `_build/`
(`utils.native_build`). ctypes releases the interpreter lock during the C
calls, so the loader threads of `data.prefetch` run them in parallel.

`available()` is False when the build fails (no g++, no OpenMP); the
failure is logged once at WARNING with g++'s message. The readers return
None for what they do not handle (a container other than mono PCM16 or
float32, an n_fft that is not a power of two), and the caller
(`data.dataset`) falls back to scipy or numpy.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from mb_istft_vits_torch.utils.native_build import (
    build_shared_lib,
    library_path,
)

logger = logging.getLogger(__name__)

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "audio.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is None and not _build_failed:
            try:
                so = build_shared_lib(SOURCE, library_path(SOURCE, "audio"))
                lib = ctypes.CDLL(so)
                lib.wav_info.argtypes = [ctypes.c_char_p,
                                         ctypes.POINTER(ctypes.c_int)]
                lib.wav_info.restype = ctypes.c_long
                lib.wav_read.argtypes = [ctypes.c_char_p,
                                         ctypes.POINTER(ctypes.c_float),
                                         ctypes.c_long]
                lib.wav_read.restype = ctypes.c_long
                lib.spectrogram_f32.argtypes = [
                    ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_float),
                ]
                lib.spectrogram_f32.restype = ctypes.c_long
                _lib = lib
            except (OSError, subprocess.CalledProcessError) as e:
                _build_failed = True
                logger.warning(
                    "native audio loader unavailable (%s), wavs are read "
                    "with scipy and host spectrograms computed with numpy: "
                    "%s", SOURCE, getattr(e, "stderr", None) or e)
    return _lib


def available() -> bool:
    """Whether the native library is built and loaded."""
    return _get_lib() is not None


def load_wav(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """(samples as float32 in the file's own scale, sampling rate), as
    scipy.io.wavfile.read gives them for a mono PCM16 or float32 wav; None
    for any other container or without the library."""
    lib = _get_lib()
    if lib is None:
        return None
    sr = ctypes.c_int(0)
    n = lib.wav_info(path.encode(), ctypes.byref(sr))
    if n < 0:
        return None
    out = np.empty(n, np.float32)
    got = lib.wav_read(path.encode(),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    if got != n:
        return None
    return out, sr.value


def spectrogram(y: np.ndarray, n_fft: int, hop: int,
                win: int) -> Optional[np.ndarray]:
    """Linear magnitude spectrogram [frames, n_fft // 2 + 1] of y [T] with
    the training front end's zero padding (`dsp.stft.spectrogram`), or None
    when n_fft is not a power of two, win > n_fft, or without the
    library."""
    lib = _get_lib()
    if lib is None or (n_fft & (n_fft - 1)) or win > n_fft:
        return None
    y = np.ascontiguousarray(y, np.float32)
    p = (n_fft - hop) // 2
    frames = 1 + (len(y) + 2 * p - n_fft) // hop
    if frames <= 0:
        return None
    out = np.empty((frames, n_fft // 2 + 1), np.float32)
    got = lib.spectrogram_f32(
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(y),
        n_fft, hop, win, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if got != frames:
        return None
    return out
