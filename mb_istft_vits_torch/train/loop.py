"""The training CLI's run (the JAX package's `train.py:235-584`): data
(device-spec PCM by default, `--host-spec` spectrograms, or the
`--device-resident` corpus on the card), resume with the epoch snap, the
step loop with loader prefetch, metrics every `log_interval` steps,
evaluation, checkpoints, best-by-eval and pruning every `eval_interval`
steps, and a checkpoint on SIGTERM.

Evaluation (`evaluate`, JAX `train.py:112-232`) runs whenever the
validation set loads. Its scalars always go to the log and decide the
best-by-eval pair; summaries, plots and audio go to TensorBoard only when
`tensorboardX` can be imported. (The JAX trainer evaluates only with a
writer, so without tensorboardX its best-by-eval record never moves.)

Data parallel (under torchrun, one process per card; JAX `train.py`'s
multi-host run): rank r takes rank r of the rank-strided batcher, so the
global batch is world x batch_size rows and `steps_per_epoch` counts one
rank's batches. Every rank steps to the same boundaries; rank 0 alone
logs (the metrics are the global batch's), evaluates, saves the pairs,
keeps best.json, prunes and writes config.json and githash. A SIGTERM to
any rank is agreed by an all-reduce at each step boundary, so every rank
stops at the same step, rank 0 writes the pair and all exit 0.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import signal
import subprocess
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from mb_istft_vits_torch.config import Config
from mb_istft_vits_torch.data import (
    BucketedBatcher,
    DeviceResidentFeeder,
    TextAudioDataset,
    device_prefetch,
    prefetch_epoch,
)
from mb_istft_vits_torch.device import disable_tf32
from mb_istft_vits_torch.parallel import init_distributed, shard_train_state_dp
from mb_istft_vits_torch.train import checkpoint
from mb_istft_vits_torch.train.step import create_train_state, train_step

BEST_METRIC = "eval/mcd_copy_synthesis"
LOADER_THREADS = 8  # the reference's DataLoader(num_workers=8)


def _logger(model_dir: str, rank: int = 0) -> logging.Logger:
    """Logger of this run: to stdout and model_dir/train.log (reference
    utils.py:228-240); handlers of an earlier run in the process go. A
    rank other than 0 logs only warnings, to stderr."""
    logger = logging.getLogger(f"mb_istft_vits_torch.train:{model_dir}")
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    logger.propagate = False
    _close(logger)
    fmt = logging.Formatter("%(asctime)s\t%(levelname)s\t%(message)s")
    handlers = ((logging.FileHandler(os.path.join(model_dir, "train.log")),
                 logging.StreamHandler(sys.stdout)) if rank == 0
                else (logging.StreamHandler(sys.stderr),))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def _close(logger: logging.Logger) -> None:
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


def check_git_hash(model_dir: str, logger: logging.Logger) -> None:
    """Record the source's git commit in model_dir/githash, or warn when
    it differs from the recorded one (reference utils.py:208-225). A
    checkout without .git records nothing."""
    source_dir = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.realpath(__file__))))
    if not os.path.exists(os.path.join(source_dir, ".git")):
        return
    cur = subprocess.run(["git", "rev-parse", "HEAD"], cwd=source_dir,
                         capture_output=True, text=True).stdout.strip()
    path = os.path.join(model_dir, "githash")
    if os.path.exists(path):
        with open(path) as f:
            saved = f.read()
        if saved != cur:
            logger.warning("git hash mismatch: %s(saved) != %s(current)",
                           saved[:8], cur[:8])
    else:
        with open(path, "w") as f:
            f.write(cur)


def make_eval_dataset(cfg: Config, logger: logging.Logger
                      ) -> Optional[TextAudioDataset]:
    """The validation set, built once at start-up (the cleaners run over
    every row, and a broken filelist shows before training starts); None
    when it cannot be read. Its items carry PCM only: `evaluate` computes
    the spectrogram of item 0 on the card, so a host spectrogram (and its
    `.spec.npy` beside the validation wav) would go unused. The JAX
    trainer builds it with the host-spec default (ROADMAP, "Known
    differences")."""
    try:
        return TextAudioDataset(cfg.data.validation_files, cfg.data,
                                seed=cfg.train.seed, device_spec=True)
    except (OSError, ValueError, IndexError, KeyError) as e:
        logger.warning("eval disabled: %s", e)
        return None


def _tensorboard(model_dir: str):
    """A tensorboardX SummaryWriter on model_dir, or None without
    tensorboardX."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=model_dir)


def evaluate(cfg: Config, net_g, global_step: int, logger: logging.Logger,
             eval_ds: Optional[TextAudioDataset], writer=None
             ) -> Optional[Dict[str, float]]:
    """Validation item 0: `infer` per speaker (draws seeded by the step),
    `reconstruct` of its spectrogram (copy synthesis) with the MCD, LSD and
    F0 metrics against the ground truth, and the TTS output's DTW-aligned
    MCD and duration ratio against it. Returns the scalars (None without a
    validation set); with a writer, also the audio, the alignment plot and
    the speaker embeddings."""
    from mb_istft_vits_torch.dsp.stft import spectrogram
    from mb_istft_vits_torch.utils import metrics

    if eval_ds is None or len(eval_ds) == 0:
        return None
    t0 = time.monotonic()
    d = cfg.data
    device = next(net_g.parameters()).device
    multi = d.n_speakers > 1
    try:
        item = eval_ds[0]
    except (OSError, ValueError) as e:  # a missing or foreign-rate wav
        logger.warning("eval skipped: %s", e)
        return None
    gt = np.asarray(item["wav"], np.float32).reshape(-1)
    x = torch.from_numpy(np.asarray(item["x"], np.int64)[None]).to(device)
    x_lengths = torch.tensor([x.shape[1]], device=device)
    audio = {"gt/audio": gt}
    item_sid = int(item.get("sid", 0)) if multi else None
    tts_audio, attn = None, None
    scalars: Dict[str, float] = {}
    was_training = net_g.training
    net_g.eval()
    try:
        with torch.no_grad():
            for s in (range(d.n_speakers) if multi else [None]):
                sid = None if s is None else torch.tensor([s], device=device)
                out = net_g.infer(x, x_lengths, sid, max_frames=1000,
                                  generator=torch.Generator(device)
                                  .manual_seed(global_step))
                n = int(out.y_lengths[0])
                key = "gen/audio" if s is None else f"gen/audio_spk_{s}"
                audio[key] = out.o[0, :n * d.hop_length, 0].float().cpu() \
                    .numpy()
                attn = out.attn[0, :n].cpu().numpy()
                if s == item_sid:
                    tts_audio = audio[key]
            try:
                spec = spectrogram(torch.from_numpy(gt[None]).to(device),
                                   d.filter_length, d.hop_length,
                                   d.win_length).transpose(1, 2)
                recon, _ = net_g.reconstruct(
                    spec, torch.tensor([spec.shape[1]], device=device),
                    torch.tensor([0], device=device) if multi else None,
                    generator=torch.Generator(device).manual_seed(
                        global_step))
                recon = recon[0, :, 0].float().cpu().numpy()
                n_mels = min(d.n_mel_channels, d.filter_length // 2 + 1)
                stft_args = dict(n_fft=d.filter_length,
                                 hop_length=d.hop_length,
                                 win_length=d.win_length)
                sr = d.sampling_rate
                scalars["eval/mcd_copy_synthesis"] = \
                    metrics.mel_cepstral_distortion(gt, recon, sr,
                                                    n_mels=n_mels,
                                                    **stft_args)
                scalars["eval/lsd_copy_synthesis"] = \
                    metrics.log_spectral_distance(gt, recon, sr, **stft_args)
                if len(gt) >= 4096:
                    f0 = metrics.f0_metrics(gt, recon, sr)
                    scalars["eval/f0_rmse_hz"] = f0["f0_rmse_hz"]
                    scalars["eval/voicing_decision_error"] = \
                        f0["voicing_decision_error"]
                audio["gen/audio_copy_synthesis"] = recon[:len(gt)]
                if tts_audio is not None and len(tts_audio):
                    tts = metrics.mcd_dtw(gt, tts_audio, sr, n_mels=n_mels,
                                          **stft_args)
                    scalars["eval/mcd_tts_dtw"] = tts["mcd_dtw"]
                    scalars["eval/dur_ratio_tts"] = tts["dur_ratio"]
            except Exception:  # the run goes on without this eval's scores
                logger.exception("eval: copy-synthesis metrics failed")
    finally:
        net_g.train(was_training)
    if writer is not None:
        _summarize_eval(writer, cfg, net_g, global_step, scalars, audio,
                        attn, logger)
    if scalars:
        logger.info("eval: %s", "  ".join(
            f"{k.split('/')[-1]}={v:.3f}" for k, v in scalars.items()))
    logger.info("eval: %d audio clips in %.2fs", len(audio),
                time.monotonic() - t0)
    return scalars


def _summarize_eval(writer, cfg, net_g, global_step, scalars, audio, attn,
                    logger) -> None:
    from mb_istft_vits_torch.utils.observability import (
        plot_alignment_to_numpy,
        summarize,
    )

    if cfg.data.n_speakers > 1:
        # speaker-embedding projector (reference train_latest.py:257-261)
        writer.add_embedding(
            net_g.emb_g.weight.detach().cpu().numpy(),
            metadata=[str(i) for i in range(cfg.data.n_speakers)],
            global_step=global_step, tag="speaker_embeddings")
    try:
        images = {"eval/attn": plot_alignment_to_numpy(attn)}
    except ImportError:  # no matplotlib: scalars and audio only
        logger.warning("eval: matplotlib is missing, no alignment plot")
        images = {}
    summarize(writer, global_step, scalars=scalars, images=images,
              audios=audio, audio_sampling_rate=cfg.data.sampling_rate)


def _batches(batcher: BucketedBatcher, first_epoch: int, epochs: int,
             device: torch.device,
             feeder: Optional[DeviceResidentFeeder] = None):
    """Every batch of epochs first_epoch .. epochs - 1, in order, on
    `device`: gathered on the card by `feeder`, or assembled by loader
    threads ahead of the step and copied to the card ahead of the batch's
    use."""
    for epoch in range(first_epoch, epochs):
        if feeder is not None:  # only the index vector crosses per step
            yield from feeder.iter_epoch(epoch)
            continue
        with contextlib.closing(device_prefetch(
                prefetch_epoch(batcher, epoch, LOADER_THREADS),
                device=device)) as epoch_batches:
            yield from epoch_batches


def _evaluate_and_save(cfg, state, model_dir, logger, eval_ds, writer,
                       best_eval) -> None:
    """At an eval step: evaluate, save the pair, record it as the best
    when its copy-synthesis MCD is the lowest yet, prune the others."""
    step = state.step
    scalars = evaluate(cfg, state.net_g, step, logger, eval_ds, writer)
    checkpoint.save(model_dir, state)
    logger.info("saved checkpoint at %d", step)
    value = (scalars or {}).get(BEST_METRIC)
    if value is not None and (best_eval["value"] is None
                              or value < best_eval["value"]):
        best_eval.update(step=step, value=value)
        checkpoint.record_best(model_dir, step, BEST_METRIC, value)
        logger.info("best checkpoint: step %d (%s %.3f)", step, BEST_METRIC,
                    value)
    keep = () if best_eval["step"] is None else (best_eval["step"],)
    pruned = checkpoint.prune(model_dir, keep_steps=keep)
    if pruned:
        logger.info("pruned checkpoints: %s", pruned)


class _Sigterm:
    """Records a SIGTERM for the loop to act on at the next step boundary;
    the previous handler comes back on exit. Outside the main thread
    (where handlers cannot be set) it records nothing. In a process group,
    `agreed` is true once any rank has received one (JAX
    `preempt_agreed`): a rank that stopped alone would leave the others
    waiting in the next all-reduce."""

    def __init__(self, device: torch.device):
        self.received = False
        self._previous = None
        self._device = device

    def _on_signal(self, signum, frame):
        self.received = True

    def agreed(self) -> bool:
        if not dist.is_initialized():
            return self.received
        flag = torch.tensor([int(self.received)], device=self._device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def __enter__(self):
        try:
            self._previous = signal.signal(signal.SIGTERM, self._on_signal)
        except ValueError:
            self._previous = None
        return self

    def __exit__(self, *exc):
        if self._previous is not None:
            signal.signal(signal.SIGTERM, self._previous)


def run(args: argparse.Namespace) -> int:
    """The CLI's run; `args` as `train.__main__` parses them. Under
    torchrun it starts the process group (NCCL on CUDA, gloo on the CPU)
    and runs this rank's share; it ends the group on the way out."""
    info = init_distributed(device=args.device)
    try:
        return _run(args, info)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args: argparse.Namespace, info) -> int:
    from mb_istft_vits_torch.utils.observability import enable_nan_debugging

    device, rank0 = info.device, info.rank == 0
    if device.type == "cuda":
        disable_tf32()
    cfg = Config.from_json(args.config)
    seed = cfg.train.seed if args.seed is None else args.seed
    torch.manual_seed(seed)  # dropout
    model_dir = os.path.join("logs", args.model)
    os.makedirs(model_dir, exist_ok=True)
    logger = _logger(model_dir, info.rank)
    anomaly = torch.is_anomaly_enabled()
    writer = None
    try:
        if rank0:
            check_git_hash(model_dir, logger)
            with open(args.config) as f:  # the config snapshot (utils.py:172)
                cfg_text = f.read()
            with open(os.path.join(model_dir, "config.json"), "w") as f:
                f.write(cfg_text)
        dataset = TextAudioDataset(cfg.data.training_files, cfg.data,
                                   seed=cfg.train.seed,
                                   device_spec=not args.host_spec)
        bucket_kw = {}
        if args.boundaries:
            bucket_kw["boundaries"] = [int(v) for v in
                                       args.boundaries.split(",")]
        batcher = BucketedBatcher(dataset, cfg.train.batch_size,
                                  num_replicas=info.world, rank=info.rank,
                                  **bucket_kw)
        spe = len(batcher)
        if spe == 0:
            raise ValueError(
                f"{cfg.data.training_files}: no batch ({len(dataset)} usable "
                f"rows, batch size {cfg.train.batch_size} x {info.world} "
                f"ranks)")
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, steps_per_epoch=spe))
        logger.info("dataset: %d utts, %d steps/epoch, buckets %s, "
                    "device %s", len(dataset), spe, batcher.boundaries,
                    device)
        if dist.is_initialized():
            logger.info("process group: %d rank(s) over %s, a global batch "
                        "of %d", info.world, dist.get_backend(),
                        info.world * cfg.train.batch_size)
        feeder = None
        if args.device_resident:
            if args.host_spec:
                logger.warning("--device-resident requires device-spec "
                               "feeding — falling back to host feeding")
            else:
                logger.info("device-resident corpus: uploading ~%.2f GB of "
                            "bucket-padded pools to %s",
                            DeviceResidentFeeder.corpus_bytes(batcher) / 1e9,
                            device)
                feeder = DeviceResidentFeeder(batcher, logger=logger,
                                              device=device)
        state = create_train_state(cfg, device, seed)
        if args.debug_nans:
            enable_nan_debugging()
        start = checkpoint.resume(model_dir, state,
                                  weights_only=args.reset_optimizer)
        if start is not None:
            snapped = checkpoint.snap_to_epoch(state, spe)
            logger.info("resumed from step %d%s%s", start,
                        f" (snapped to epoch boundary {snapped})"
                        if snapped != start else "",
                        " (optimizer reset)" if args.reset_optimizer else "")
        shard_train_state_dp(state)
        eval_ds, best_eval = None, {"step": None, "value": None}
        if rank0:
            writer = _tensorboard(model_dir)
            eval_ds = make_eval_dataset(cfg, logger)
            best = checkpoint.best_step(model_dir) or {}
            best_eval = {"step": best.get("step"), "value": best.get("value")}
        last = args.max_steps or cfg.train.epochs * spe
        t = cfg.train
        t_last = time.perf_counter()
        first_epoch = state.step // spe if state.step < last else t.epochs
        batches = _batches(batcher, first_epoch, t.epochs, device, feeder)
        with _Sigterm(device) as sigterm, contextlib.closing(batches):
            for batch in batches:
                metrics = train_step(state, batch)
                step = state.step
                stop = sigterm.agreed()
                if rank0 and step % t.log_interval == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    now = time.perf_counter()
                    m["steps_per_sec"] = t.log_interval / (now - t_last)
                    t_last = now
                    logger.info("step %d: %s", step, json.dumps(m))
                    if writer is not None:
                        for k, v in m.items():
                            writer.add_scalar(k, v, step)
                if rank0 and step % t.eval_interval == 0:
                    _evaluate_and_save(cfg, state, model_dir, logger,
                                       eval_ds, writer, best_eval)
                elif rank0 and (stop or step >= last):
                    checkpoint.save(model_dir, state)
                    logger.info("saved checkpoint at %d", step)
                if stop:
                    logger.info("SIGTERM: checkpointed at step %d, exiting",
                                step)
                if stop or step >= last:
                    break
        if dist.is_initialized():
            dist.barrier()  # rank 0's last pair is on disk
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
        if writer is not None:
            writer.close()
        _close(logger)
    return 0
