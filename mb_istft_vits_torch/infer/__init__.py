"""Inference / serving layer."""

from mb_istft_vits_torch.infer.synthesis import (  # noqa: F401
    SynthesisModule,
    get_synthesis_module_instance,
)
