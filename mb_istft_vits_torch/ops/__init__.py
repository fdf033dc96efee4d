from mb_istft_vits_torch.ops.mas import maximum_path  # noqa: F401
from mb_istft_vits_torch.ops.segments import (  # noqa: F401
    add_timing_signal_1d,
    cat_timing_signal_1d,
    generate_path,
    get_timing_signal_1d,
    rand_slice_segments,
    sequence_mask,
    slice_segments,
)
