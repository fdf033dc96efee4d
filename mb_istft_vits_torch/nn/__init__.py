from mb_istft_vits_torch.nn.attention import (  # noqa: F401
    FFN,
    MultiHeadAttention,
    TransformerEncoder,
)
from mb_istft_vits_torch.nn.blocks import (  # noqa: F401
    WN,
    DDSConv,
    ResBlock1,
    ResBlock2,
)
from mb_istft_vits_torch.nn.flows import (  # noqa: F401
    ConvFlow,
    ElementwiseAffine,
    Flip,
    Log,
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
