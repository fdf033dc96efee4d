"""MB-iSTFT-VITS on PyTorch and CUDA (NVIDIA Hopper).

A port of `mb_istft_vits_tpu` that keeps that package's behaviour and
public layouts and never imports it (nor JAX). What is ported so far:

  - every shipped config and `use_sdp`: the multi-band, single-band and
    multi-stream iSTFT heads, the deterministic and the stochastic
    duration predictors, the English and Japanese frontends,
    multi-speaker models and voice conversion (`python -m
    mb_istft_vits_torch.voice_conversion`)
  - serving (`infer.synthesis.SynthesisModule`): text -> waveform
    at static text / frame buckets, the long-text split, batched
    synthesis with resampling on the device, streaming, batched and
    spectrogram-joined chunked decodes; the micro-batcher and the
    streaming engine (`serve`); the CLIs `python -m
    mb_istft_vits_torch.synthesize`, `.synthesize_z` and
    `.batch_synthesize`
  - the GAN trainer (`train`, `python -m mb_istft_vits_torch.train`): one
    generator forward a step, whose Monotonic Alignment Search runs in
    hand-written CUDA kernels (`csrc/mas.cu`, bound in `kernels.py`,
    dispatched by `ops/mas.py`), a discriminator step, then a generator
    step against the updated discriminator; the CLI evaluates at
    `eval_interval` (`utils.metrics`), keeps the best-by-eval checkpoint,
    prunes the rest and checkpoints on SIGTERM
  - the training data (`data`): wavs read and host spectrograms computed
    in C++ (`csrc/audio.cpp`), `.spec.npy` caches, rank-strided length
    buckets, and the three feeds of the trainer: int16 PCM with the
    spectrogram on the card, host spectrograms (`--host-spec`), the
    corpus held on the card (`--device-resident`)
  - bf16 serving (`SynthesisModule(..., compute_dtype=torch.bfloat16)`)
    and the offline tools (`python -m mb_istft_vits_torch.eval_checkpoint`,
    `.eval_metrics`, `.eval_vc`, `.make_corpus`, `.preprocess`)

Modules run in torch's [B, C, T] layout inside; the public `Synthesizer`
methods take and return the JAX package's [B, T, C] layouts. Entry points
run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

import os as _os

# cuDNN engines the port never takes (`cudnn_errata.json`, where each is
# named with why): torch's cuDNN frontend reads the file this names once,
# at the process's first convolution, and skips the engines it lists when
# it ranks a convolution's plans. A file the caller names is kept.
_os.environ.setdefault("CUDNN_ERRATA_JSON_FILE", _os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "cudnn_errata.json"))

from mb_istft_vits_torch.config import HParams, load_hparams  # noqa: F401,E402
