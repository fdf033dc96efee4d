"""Host-side training data: filelist dataset and length-bucketed
static-shape batching."""

from mb_istft_vits_torch.data.dataset import (  # noqa: F401
    BucketedBatcher,
    TextAudioDataset,
    load_filepaths_and_text,
    load_wav,
)
