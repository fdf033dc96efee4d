"""Serving core: text -> int16 PCM (counterpart of the single-request path
of `mb_istft_vits_tpu/infer/synthesis.py:SynthesisModule`).

One request at a time: frontend ids -> duration probe (`predict_frames`)
to size the decode -> `Synthesizer.infer` -> trim to y_len * hop -> int16.
Buckets, batching, streaming and long-text splitting are a later slice.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from mb_istft_vits_torch.config import Config
from mb_istft_vits_torch.device import disable_tf32, resolve_device
from mb_istft_vits_torch.models import Synthesizer
from mb_istft_vits_torch.text import frontend_ids
from mb_istft_vits_torch.weights import load_generator_pth


class SynthesisModule:
    """Loads a config and generator weights (a reference `G_*.pth`, or
    random weights from `seed`) and synthesizes one text per call."""

    def __init__(self, config_path: str,
                 checkpoint_path: Optional[str] = None, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        self.config = Config.from_json(config_path)
        self.cfg, self.data_cfg = self.config.model, self.config.data
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = Synthesizer(self.cfg)
        if checkpoint_path is not None:
            model.load_state_dict(load_generator_pth(checkpoint_path))
        self.model = model.to(self.device).eval()
        self.hop_length = self.data_cfg.hop_length
        self.sampling_rate = self.data_cfg.sampling_rate
        self._generator = torch.Generator(self.device).manual_seed(seed)

    def text_to_ids(self, text: str) -> np.ndarray:
        d = self.data_cfg
        return np.asarray(frontend_ids(text, d.text_module, d.text_cleaners,
                                       d.add_blank, d.cleaned_text), np.int64)

    @torch.no_grad()
    def synthesize(self, text: str, noise_scale: float = 0.667,
                   length_scale: float = 1.0, seed: Optional[int] = None
                   ) -> Tuple[np.ndarray, Dict[str, float]]:
        """-> (int16 PCM [T_wav], timings). timings: `total` seconds from
        the ids to the PCM on the host, `audio_seconds`, `rtf`."""
        ids = self.text_to_ids(text)
        if ids.size == 0:
            raise ValueError("text maps to no symbols")
        t0 = time.perf_counter()
        x = torch.from_numpy(ids)[None].to(self.device)
        x_lengths = torch.tensor([ids.size], device=self.device)
        gen = (self._generator if seed is None
               else torch.Generator(self.device).manual_seed(seed))
        frames = int(self.model.predict_frames(x, x_lengths,
                                               length_scale)[0])
        out = self.model.infer(x, x_lengths, noise_scale, length_scale,
                               max_frames=frames, generator=gen)
        y_len = int(out.y_lengths[0])
        wav = out.o[0, :y_len * self.hop_length, 0].float().clamp(-1.0, 1.0)
        pcm = torch.round(wav * 32767.0).to(torch.int16).cpu().numpy()
        total = time.perf_counter() - t0
        audio_seconds = pcm.size / self.sampling_rate
        return pcm, {"total": total, "audio_seconds": audio_seconds,
                     "rtf": total / max(audio_seconds, 1e-9),
                     "frames": float(y_len)}
