"""DSP on torch: STFT / iSTFT, the PQMF filterbank, mel spectrograms and
resampling (the JAX package's `dsp` names; its jnp-only
`resample_poly_jax` is `resample_poly_torch` here)."""

from mb_istft_vits_torch.dsp.stft import (  # noqa: F401
    TorchSTFT,
    hann_window,
    istft,
    spectrogram,
    stft,
    stft_magnitude,
)
from mb_istft_vits_torch.dsp.pqmf import (  # noqa: F401
    PQMF,
    PQMFBank,
    design_prototype_filter,
)
from mb_istft_vits_torch.dsp.mel import (  # noqa: F401
    mel_filterbank,
    mel_spectrogram,
    spec_to_mel,
    spectral_normalize,
)
from mb_istft_vits_torch.dsp.resample import (  # noqa: F401
    PolyphaseStreamResampler,
    design_resample_filter,
    resample_poly,
    resample_poly_torch,
)
