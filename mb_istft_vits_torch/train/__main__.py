"""Train the generator and discriminator on a filelist (the reference's
`python train_latest.py -c CONFIG -m NAME`; the JAX package's `train.py`,
with its argument names and meanings).

    python -m mb_istft_vits_torch.train -c configs/ljs_mb_istft_vits.json \
        -m NAME [--max-steps N] [--reset-optimizer] [--host-spec]
        [--device-resident] [--boundaries F0,F1,..] [--debug-nans]
        [--device cuda|cpu] [--seed S]

    torchrun --nproc_per_node N -m mb_istft_vits_torch.train -c ... -m ...

On N cards (torchrun, one process per card, the reference's NCCL DDP):
rank r trains on rank r's share of every global batch of N x batch_size
rows, on card LOCAL_RANK, and the step's losses and gradients are the
global batch's. Rank 0 alone logs, evaluates and writes checkpoints; a
SIGTERM to any rank stops all of them at one step, with a pair. With
--device cpu the ranks run on the CPU over gloo.

Everything goes to logs/NAME/: train.log (one line of metrics every
`log_interval` steps, to stdout too), the config and git commit, and
every `eval_interval` steps an evaluation (copy-synthesis MCD / LSD / F0
and the TTS output's DTW MCD, logged; with tensorboardX installed, also
TensorBoard summaries with audio) and a G_{step}.pth / D_{step}.pth pair.
best.json names the pair with the lowest copy-synthesis MCD; older pairs
are pruned to the newest 3, that one and every multiple of 25000. A run
resumes from the newest pair, at the start of its epoch. SIGTERM saves a
pair at the next step boundary and exits 0; so does the last step. Runs
on CUDA unless --device cpu; without a card it raises.

Feeding: by default batches carry int16 PCM and the spectrogram is
computed on the card. --host-spec is the reference pipeline: host
spectrograms, cached as .spec.npy beside each wav. --device-resident
uploads the whole bucket-padded corpus to the card once and gathers each
batch there (with --host-spec it warns and feeds from the host). The
loader reads wavs and computes host spectrograms in C++
(`csrc/audio.cpp`, built with g++ into `mb_istft_vits_torch/_build/` at
first use), else with scipy and numpy, with a warning.

Not carried over from the JAX CLI: --aot-cache (nothing is compiled ahead
of time in eager PyTorch).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True,
                    help="JSON config (reference schema)")
    ap.add_argument("-m", "--model", required=True,
                    help="model name: checkpoints and log in logs/NAME")
    ap.add_argument("--max-steps", type=int, default=0,
                    help="stop after this global step (0: the config's "
                         "epochs)")
    ap.add_argument("--reset-optimizer", action="store_true",
                    help="resume the weights but not the optimizer state: "
                         "the lr schedule starts again from the initial lr "
                         "(the reference's train_latest_fixed.py:117-128)")
    ap.add_argument("--host-spec", action="store_true",
                    help="compute linear spectrograms on the host with a "
                         ".spec.npy cache (the reference pipeline, "
                         "data_utils.py:78-86) instead of the default "
                         "on-device spectrogram with int16 PCM feeding")
    ap.add_argument("--device-resident", action="store_true",
                    help="upload the whole bucket-padded corpus to the "
                         "card once and assemble batches with an on-device "
                         "gather: only a [batch]-int32 index vector crosses "
                         "host->device per step (int16 PCM: ~0.16 GB/h at "
                         "22.05 kHz). Implies the default device-spec "
                         "feeding")
    ap.add_argument("--boundaries", default=None, metavar="F0,F1,...",
                    help="bucket boundaries in spectrogram frames (default: "
                         "the reference's 32,300,...,1000)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="autograd anomaly mode: a backward op that yields "
                         "NaN raises (the reference's set_detect_anomaly, "
                         "train_latest.py:40)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=None,
                    help="weights and draws (default: the config's "
                         "train.seed)")
    args = ap.parse_args(argv)

    from mb_istft_vits_torch.train.loop import run

    return run(args)


if __name__ == "__main__":
    sys.exit(main())
