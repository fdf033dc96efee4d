"""Typed configuration: reads the reference JSON configs (`configs/*.json`).

The port's own copy of `HParams`, `load_hparams`, `ModelConfig`,
`DataConfig`, `TrainConfig` and `Config` of the JAX package's `config.py`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Sequence


class HParams:
    """Recursive attribute dict (reference `utils.py:243-272`)."""

    def __init__(self, **kwargs: Any) -> None:
        for k, v in kwargs.items():
            if isinstance(v, dict):
                v = HParams(**v)
            self[k] = v

    def keys(self):
        return self.__dict__.keys()

    def items(self):
        return self.__dict__.items()

    def values(self):
        return self.__dict__.values()

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, HParams) else v
                for k, v in self.__dict__.items()}

    def __len__(self) -> int:
        return len(self.__dict__)

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def __setitem__(self, key: str, value: Any) -> Any:
        return setattr(self, key, value)

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def __repr__(self) -> str:
        return repr(self.__dict__)


def load_hparams(config_path: str) -> HParams:
    """Load a reference-format JSON config (reference `utils.py:150-156`)."""
    with open(config_path, "r") as f:
        return HParams(**json.load(f))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyperparameters (reference `models.py:573-599` ctor args
    plus the `model` block of `configs/*.json`)."""

    n_vocab: int
    spec_channels: int
    segment_size: int  # in frames (train.segment_size // data.hop_length)
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    resblock: str = "1"
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    upsample_rates: Sequence[int] = (4, 4)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (16, 16)
    gen_istft_n_fft: int = 16
    gen_istft_hop_size: int = 4
    n_speakers: int = 0
    gin_channels: int = 0
    use_sdp: bool = False
    ms_istft_vits: bool = False
    mb_istft_vits: bool = False
    subbands: int = 4
    istft_vits: bool = False
    use_spectral_norm: bool = False

    @property
    def decoder_kind(self) -> str:
        """Decoder dispatch, mirroring reference `models.py:634-644`; a
        config that sets none of the three iSTFT flags is VITS's own, whose
        decoder is the HiFi-GAN generator (VITS `models.py:Generator`)."""
        if self.mb_istft_vits:
            return "mb_istft"
        if self.ms_istft_vits:
            return "ms_istft"
        if self.istft_vits:
            return "istft"
        return "hifigan"

    @staticmethod
    def from_hparams(hps: HParams, n_vocab: int) -> "ModelConfig":
        fields = {f.name for f in dataclasses.fields(ModelConfig)}
        kwargs = {k: v for k, v in hps.model.items() if k in fields}
        # JSON lists -> (nested) tuples, so a loaded config is hashable
        for k, v in kwargs.items():
            if isinstance(v, list):
                kwargs[k] = tuple(
                    tuple(x) if isinstance(x, list) else x for x in v
                )
        # `subbands: false` in istft-only configs
        if not kwargs.get("subbands"):
            kwargs["subbands"] = 4
        # n_speakers comes from the data block (reference train_latest.py:96)
        kwargs["n_speakers"] = getattr(hps.data, "n_speakers", 0)
        kwargs["n_vocab"] = n_vocab
        kwargs["spec_channels"] = hps.data.filter_length // 2 + 1
        kwargs["segment_size"] = hps.train.segment_size // hps.data.hop_length
        return ModelConfig(**kwargs)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """`data` block of configs (reference `configs/ljs_mb_istft_vits.json`)."""

    training_files: str = ""
    validation_files: str = ""
    text_cleaners: Sequence[str] = ("english_cleaners2",)
    max_wav_value: float = 32768.0
    sampling_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None
    add_blank: bool = True
    n_speakers: int = 0
    cleaned_text: bool = True
    text_module: str = "text"
    min_text_len: int = 1
    max_text_len: int = 190

    @staticmethod
    def from_hparams(hps: HParams) -> "DataConfig":
        fields = {f.name for f in dataclasses.fields(DataConfig)}
        kwargs = {k: v for k, v in hps.data.items() if k in fields}
        if "text_cleaners" in kwargs:
            kwargs["text_cleaners"] = tuple(kwargs["text_cleaners"])
        return DataConfig(**kwargs)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """`train` block of configs, plus the JAX package's two additions:
    the generator's gradient value clip and the steps per epoch of the lr
    schedule (0 = derived from the dataset by the trainer)."""

    log_interval: int = 200
    eval_interval: int = 100000
    seed: int = 1234
    epochs: int = 20000
    learning_rate: float = 2e-4
    betas: Sequence[float] = (0.8, 0.99)
    eps: float = 1e-9
    batch_size: int = 64
    fp16_run: bool = False  # bf16 autocast, f32 master weights and losses
    lr_decay: float = 0.999875
    segment_size: int = 8192
    c_mel: float = 45.0
    c_kl: float = 1.0
    fft_sizes: Sequence[int] = (384, 683, 171)
    hop_sizes: Sequence[int] = (30, 60, 10)
    win_lengths: Sequence[int] = (150, 300, 60)
    window: str = "hann_window"
    grad_clip_value: float = 1.0
    steps_per_epoch: int = 0

    @staticmethod
    def from_hparams(hps: HParams) -> "TrainConfig":
        fields = {f.name for f in dataclasses.fields(TrainConfig)}
        kwargs = {k: v for k, v in hps.train.items() if k in fields}
        for key in ("betas", "fft_sizes", "hop_sizes", "win_lengths"):
            if key in kwargs:
                kwargs[key] = tuple(kwargs[key])
        return TrainConfig(**kwargs)


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig
    data: DataConfig
    train: TrainConfig

    @staticmethod
    def from_json(config_path: str, n_vocab: Optional[int] = None) -> "Config":
        hps = load_hparams(config_path)
        data = DataConfig.from_hparams(hps)
        if n_vocab is None:
            from mb_istft_vits_torch.text import get_symbols

            n_vocab = len(get_symbols(data.text_module))
        return Config(model=ModelConfig.from_hparams(hps, n_vocab=n_vocab),
                      data=data, train=TrainConfig.from_hparams(hps))
