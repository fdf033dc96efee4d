"""The GAN trainer: the step (`train.step`), reference-format checkpoints
(`train.checkpoint`) and the CLI (`python -m mb_istft_vits_torch.train`)."""

from mb_istft_vits_torch.train.step import (  # noqa: F401
    StepDraws,
    TrainState,
    create_train_state,
    make_lr_schedule,
    prep_batch,
    train_step,
)
