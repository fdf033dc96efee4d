"""Overfit sanity check (the JAX package's `scripts/overfit_check.py`;
SURVEY.md §7's minimum slice): train the tiny multi-band config on one
fixed synthetic batch and require the mel reconstruction loss to drop
below 0.7 of its first value. It shows that gradients flow end to end
through MAS (the CUDA kernels on a card), the flows, the decoder and both
GAN updates.

    python -m mb_istft_vits_torch.overfit_check [--steps 150] [--cpu]

The config, the batch (`numpy.random.RandomState(0)`: 8 utterances of
4096 samples at 8 kHz, each a sum of three sinusoids, and their
256/64/256 spectrograms), the prints and the gate are the JAX script's.
It runs on the card unless `--cpu` is given; a missing card is an error.
`run(steps, device)` and `gate(result)` are the two halves for a caller
in this process.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict

import numpy as np
import torch

from mb_istft_vits_torch.config import (Config, DataConfig, ModelConfig,
                                        TrainConfig)

DROP = 0.7  # the last mel loss must be below DROP x the first


def tiny_config() -> Config:
    """The JAX script's tiny multi-band model and training settings."""
    model = ModelConfig(
        n_vocab=40, spec_channels=129, segment_size=16,
        inter_channels=32, hidden_channels=32, filter_channels=64,
        n_heads=2, n_layers=2, kernel_size=3, p_dropout=0.0,
        resblock="2", resblock_kernel_sizes=(3,),
        resblock_dilation_sizes=((1, 3),),
        upsample_rates=(2, 2), upsample_initial_channel=64,
        upsample_kernel_sizes=(4, 4), gen_istft_n_fft=16,
        gen_istft_hop_size=4, subbands=4, mb_istft_vits=True,
    )
    data = DataConfig(filter_length=256, hop_length=64, win_length=256,
                      n_mel_channels=20, sampling_rate=8000)
    train = TrainConfig(batch_size=8, segment_size=1024, learning_rate=5e-4,
                        fft_sizes=(64, 128), hop_sizes=(16, 32),
                        win_lengths=(64, 128), steps_per_epoch=1000)
    return Config(model=model, data=data, train=train)


def synthetic_batch(cfg: Config) -> Dict[str, np.ndarray]:
    """The JAX script's batch, in its layouts: sums of three stable
    sinusoids a utterance, their spectrograms [B, T_spec, bins] (the
    port's front end, on the CPU) and random ids."""
    from mb_istft_vits_torch.dsp.stft import spectrogram

    rng = np.random.RandomState(0)
    b, t_x, t_wav = 8, 16, 4096
    t = np.arange(t_wav) / cfg.data.sampling_rate
    wav = np.stack([
        sum(0.2 * np.sin(2 * np.pi * f * t)
            for f in rng.uniform(100, 1500, 3))
        for _ in range(b)
    ]).astype(np.float32)
    with torch.no_grad():
        spec = spectrogram(torch.from_numpy(wav), 256, 64, 256).numpy()
    return {
        "x": rng.randint(1, 40, size=(b, t_x)).astype(np.int32),
        "x_lengths": np.full(b, t_x, np.int32),
        "spec": np.ascontiguousarray(spec.transpose(0, 2, 1)),
        "spec_lengths": np.full(b, spec.shape[2], np.int32),
        "wav": wav[..., None],
        "wav_lengths": np.full(b, t_wav, np.int32),
    }


def run(steps: int = 150, device: str = "cuda") -> dict:
    """`steps` train steps of the tiny config on the synthetic batch, on
    `device`, printing as the JAX script does. Returns the first and last
    mel loss, the last step's metrics and each step's host ms (synced);
    `gate` holds them to the script's bar."""
    from mb_istft_vits_torch.train.step import (create_train_state,
                                                train_step)

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --cpu to run on the CPU)")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = tiny_config()
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in synthetic_batch(cfg).items()}
    state = create_train_state(cfg, dev, seed=0)

    first_mel, step_ms, metrics = None, [], {}
    t0 = time.perf_counter()
    for i in range(steps):
        sync()
        start = time.perf_counter()
        metrics = train_step(state, batch)
        sync()
        step_ms.append((time.perf_counter() - start) * 1e3)
        if i == 0:
            first_mel = float(metrics["loss/g/mel"])
            print(f"compile+step0: {time.perf_counter()-t0:.1f}s  "
                  f"mel={first_mel:.3f}", flush=True)
        if (i + 1) % 25 == 0:
            print(f"step {i+1}: mel={float(metrics['loss/g/mel']):.3f} "
                  f"dur={float(metrics['loss/g/dur']):.3f} "
                  f"kl={float(metrics['loss/g/kl']):.3f} "
                  f"d={float(metrics['loss/d/total']):.3f}", flush=True)
    metrics = {k: float(v) for k, v in metrics.items()}
    last_mel = metrics["loss/g/mel"]
    print(f"mel loss: {first_mel:.3f} -> {last_mel:.3f}", flush=True)
    return {"first_mel": first_mel, "last_mel": last_mel, "steps": steps,
            "metrics": metrics, "step_ms": step_ms}


def gate(result: dict) -> None:
    """The JAX script's gate: raises AssertionError unless the last mel
    loss is below 0.7 of the first."""
    if not result["last_mel"] < DROP * result["first_mel"]:
        raise AssertionError(f"mel loss did not drop enough: "
                             f"{result['first_mel']} -> {result['last_mel']}")
    print("OVERFIT CHECK PASSED", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=150)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    gate(run(args.steps, "cpu" if args.cpu else "cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
