"""Host-side PCM helpers (the port's copy of
`mb_istft_vits_tpu/utils/audio.py`): one float -> int16 conversion for the
CLIs' wav writers and the streaming chunks, so every path quantizes the
same way as the serving module does on the device."""

from __future__ import annotations

import wave

import numpy as np


def float_to_int16(audio: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> int16 PCM with round-to-nearest (matches the
    on-device quantization in infer/synthesis.py)."""
    pcm = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    return np.round(pcm * 32767.0).astype(np.int16)


def write_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """Mono 16-bit wav of float audio in [-1, 1]."""
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sr))
        w.writeframes(float_to_int16(audio).tobytes())
