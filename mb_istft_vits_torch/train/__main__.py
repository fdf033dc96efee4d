"""Train the generator and discriminator on a filelist (the reference's
`python train_latest.py -c CONFIG -m NAME`; the JAX package's `train.py`).

    python -m mb_istft_vits_torch.train -c configs/ljs_mb_istft_vits.json \
        -m NAME [--max-steps N] [--device cuda|cpu] [--seed S]

Checkpoints go to logs/NAME/ (G_{step}.pth, D_{step}.pth) every
`eval_interval` steps and at the last step; a run resumes from the newest
pair there. Every step logs one line of metrics to stdout and to
logs/NAME/train.log. Runs on CUDA unless --device cpu; without a card it
raises. Evaluation and TensorBoard logging are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time


def _logger(model_dir: str) -> logging.Logger:
    """Logger of this run: to stdout and model_dir/train.log (reference
    utils.py:228-240); handlers of an earlier run in the process go."""
    logger = logging.getLogger(f"mb_istft_vits_torch.train:{model_dir}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s\t%(levelname)s\t%(message)s")
    for h in (logging.FileHandler(os.path.join(model_dir, "train.log")),
              logging.StreamHandler(sys.stdout)):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True,
                    help="JSON config (reference schema)")
    ap.add_argument("-m", "--model", required=True,
                    help="model name: checkpoints and log in logs/NAME")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="stop after this global step (0: the config's "
                         "epochs)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=None,
                    help="weights and draws (default: the config's "
                         "train.seed)")
    args = ap.parse_args(argv)

    import torch

    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.data import BucketedBatcher, TextAudioDataset
    from mb_istft_vits_torch.device import disable_tf32, resolve_device
    from mb_istft_vits_torch.train import checkpoint
    from mb_istft_vits_torch.train.step import create_train_state, train_step

    device = resolve_device(args.device)
    if device.type == "cuda":
        disable_tf32()
    cfg = Config.from_json(args.config)
    seed = cfg.train.seed if args.seed is None else args.seed
    torch.manual_seed(seed)  # dropout
    model_dir = os.path.join("logs", args.model)
    os.makedirs(model_dir, exist_ok=True)
    logger = _logger(model_dir)
    try:
        dataset = TextAudioDataset(cfg.data.training_files, cfg.data,
                                   seed=cfg.train.seed)
        batcher = BucketedBatcher(dataset, cfg.train.batch_size)
        steps_per_epoch = len(batcher)
        if steps_per_epoch == 0:
            raise ValueError(
                f"{cfg.data.training_files}: no batch ({len(dataset)} usable "
                f"rows, batch size {cfg.train.batch_size})")
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, steps_per_epoch=steps_per_epoch))
        logger.info("dataset: %d utts, %d steps/epoch, device %s",
                    len(dataset), steps_per_epoch, device)
        state = create_train_state(cfg, device, seed)
        start = checkpoint.resume(model_dir, state)
        if start is not None:
            logger.info("resumed from step %d", start)
        last = args.max_steps or cfg.train.epochs * steps_per_epoch
        # a resumed run skips the batches of its epoch already taken
        epoch, done = divmod(state.step, steps_per_epoch)
        while state.step < last:
            for bucket, indices in batcher.epoch_batches(epoch)[done:]:
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(v).to(device) for k, v in
                         batcher.make_batch(bucket, indices).items()}
                metrics = {k: float(v) for k, v in
                           train_step(state, batch).items()}
                metrics["step_seconds"] = time.perf_counter() - t0
                logger.info("step %d: %s", state.step, json.dumps(metrics))
                if (state.step % cfg.train.eval_interval == 0
                        or state.step == last):
                    checkpoint.save(model_dir, state)
                    logger.info("saved checkpoint at step %d", state.step)
                if state.step >= last:
                    break
            epoch, done = epoch + 1, 0
    finally:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
