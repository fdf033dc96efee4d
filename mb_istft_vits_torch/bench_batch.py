"""Batched offline synthesis throughput (the JAX package's
`scripts/bench_batch.py`): `synthesize_batch` of `--batch` lines, the
production serving path, one decode for many utterances. Prints ONE JSON
line.

    python -m mb_istft_vits_torch.bench_batch [--batch 16] [--reps 5] \
        [--device cpu]

The batch's time is the host clock around `synthesize_batch`, which
returns once the audio is on the host; `device_busy_ms` is the union of
one batch's device activity (torch.profiler), null on the CPU. bf16 on
the card, float32 on the CPU, random weights from a seed.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

from mb_istft_vits_torch.bench import CONFIG, serving_module
from mb_istft_vits_torch.utils import timing

SENTENCES = [
    "ðɪs ɪz ɐ tɛst ʌv ðə mʌltibænd ɪnvɜːs ʃɔːɹt taɪm fʊɹiɐ tɹænsfɔːɹm.",
    "ə kwɪk bɹaʊn fɑks dʒʌmps oʊvɚ ðə leɪzi dɔɡ wɪθ ɡɹeɪt spiːd tədeɪ.",
    "spiːtʃ sɪnθəsɪs ɒn tɛnsɚ pɹəʊsɛsɪŋ juːnɪts ɪz ɹɪmɑːɹkəbli fæst.",
    "ðə wɛðɚ ɪn ðə maʊntənz tʊk ən ʌnɪkspɛktəd tɜːn ðɪs ɑːftɚnuːn.",
]
DEVICE_FIELDS = ("device_ms", "device_busy_ms", "device_busy_share")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=CONFIG)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--reps", type=int, default=5)
    timing.add_device_argument(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = timing.tool_device(args.device)
    module = serving_module(args.config, device)
    texts = [SENTENCES[i % len(SENTENCES)] for i in range(args.batch)]
    module.synthesize_batch(texts, seed=0)  # warm every shape

    # the audio's seconds from the timed reps themselves (lengths can vary
    # by seed when the durations are sampled)
    times, audio = [], []
    for r in range(args.reps):
        t0 = time.perf_counter()
        audios, _ = module.synthesize_batch(texts, seed=r)
        times.append(time.perf_counter() - t0)
        audio.append(sum(len(a) for a in audios) / module.sampling_rate)
    dt, secs = statistics.median(times), statistics.median(audio)
    prof = timing.busy(lambda: module.synthesize_batch(texts, seed=0), device)
    timing.emit({"metric": "batch_synthesis", "batch": args.batch,
                 "ms_per_batch": dt * 1e3, "utt_per_s": args.batch / dt,
                 "audio_s_per_s": secs / dt, "batch_rtf": dt / secs,
                 "audio_seconds": secs, "reps": args.reps,
                 **{k: prof[k] for k in DEVICE_FIELDS}}, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
