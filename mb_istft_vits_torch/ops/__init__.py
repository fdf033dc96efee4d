from mb_istft_vits_torch.ops.mas import maximum_path  # noqa: F401
from mb_istft_vits_torch.ops.segments import (  # noqa: F401
    generate_path,
    rand_slice_segments,
    sequence_mask,
    slice_segments,
)
