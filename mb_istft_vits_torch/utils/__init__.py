"""Host-side helpers, and the observability names the JAX package's
`utils` exports."""

from mb_istft_vits_torch.utils.observability import (  # noqa: F401
    enable_nan_debugging,
    plot_alignment_to_numpy,
    plot_spectrogram_to_numpy,
    profile_trace,
    summarize,
)
