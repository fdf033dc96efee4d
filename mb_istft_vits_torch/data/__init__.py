"""Host-side training data: filelist dataset, length-bucketed
static-shape batching and the loader / host-to-device prefetch."""

from mb_istft_vits_torch.data.dataset import (  # noqa: F401
    BucketedBatcher,
    TextAudioDataset,
    load_filepaths_and_text,
    load_wav,
)
from mb_istft_vits_torch.data.prefetch import (  # noqa: F401
    PrefetchIterator,
    device_prefetch,
    prefetch_epoch,
)
