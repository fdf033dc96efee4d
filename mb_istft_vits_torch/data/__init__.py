"""Host-side training data: filelist dataset, host spectrograms and the
native loader, length-bucketed static-shape batching, the loader /
host-to-device prefetch and the corpus held on the card."""

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
from mb_istft_vits_torch.data.resident import (  # noqa: F401
    DeviceResidentFeeder,
)
