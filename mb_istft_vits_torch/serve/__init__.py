"""Serving front ends over `infer.synthesis.SynthesisModule`: the
micro-batcher and the incremental streaming engine."""

from mb_istft_vits_torch.serve.microbatch import MicroBatcher  # noqa: F401
from mb_istft_vits_torch.serve.streaming import IncrementalTTS, TTSRequest  # noqa: F401
