from mb_istft_vits_torch.dsp.pqmf import PQMF  # noqa: F401
from mb_istft_vits_torch.dsp.stft import istft  # noqa: F401
