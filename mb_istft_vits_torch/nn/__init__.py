from mb_istft_vits_torch.nn.attention import (  # noqa: F401
    FFN,
    MultiHeadAttention,
    TransformerEncoder,
)
from mb_istft_vits_torch.nn.blocks import WN, ResBlock1, ResBlock2  # noqa: F401
from mb_istft_vits_torch.nn.flows import (  # noqa: F401
    Flip,
    ResidualCouplingLayer,
    flip_channels,
)
from mb_istft_vits_torch.nn.layers import (  # noqa: F401
    Conv1d,
    Conv2d,
    ConvTranspose1d,
    LayerNorm,
    get_padding,
    leaky_relu,
)
