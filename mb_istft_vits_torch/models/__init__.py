from mb_istft_vits_torch.models.decoders import (  # noqa: F401
    ISTFTGenerator,
    MultibandISTFTGenerator,
    MultistreamISTFTGenerator,
)
from mb_istft_vits_torch.models.discriminator import (  # noqa: F401
    DiscriminatorP,
    DiscriminatorS,
    MultiPeriodDiscriminator,
)
from mb_istft_vits_torch.models.duration import (  # noqa: F401
    DurationPredictor,
    StochasticDurationPredictor,
)
from mb_istft_vits_torch.models.encoders import (  # noqa: F401
    PosteriorEncoder,
    TextEncoder,
)
from mb_istft_vits_torch.models.synthesizer import (  # noqa: F401
    InferOutput,
    ResidualCouplingBlock,
    Synthesizer,
)
