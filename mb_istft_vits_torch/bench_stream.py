"""Streaming decode benchmark (the JAX package's `scripts/bench_stream.py`):
time to the first audio (TTFA) and the stream's RTF of
`stream_from_latents` with fixed 64-frame chunks and with the growing
plan (the default), on a ~4 s and a ~12 s utterance. Prints ONE JSON
line.

    python -m mb_istft_vits_torch.bench_stream [--reps 5] [--device cpu]

TTFA and the total are host-clock medians of `--reps` streams, each
chunk on the host when it is counted; `device_busy_ms` is the union of
one stream's device activity (torch.profiler), null on the CPU. The
reference anchor is the chunked-z spec-join decode at RTF 0.0542 on a
CPU (inferz_test.ipynb cell 7). bf16 on the card, float32 on the CPU.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

from mb_istft_vits_torch.bench import CONFIG, serving_module
from mb_istft_vits_torch.utils import timing

SENTENCE = ("ðɪs ɪz ɐ tɛst ʌv ðə mʌltibænd ɪnvɜːs ʃɔːɹt taɪm fʊɹiɐ "
            "tɹænsfɔːɹm sɪstəm fɔːɹ ɛnd tuː ɛnd spiːtʃ sɪnθəsɪs. ")
PLANS = {"fixed_64": {"grow_chunks": False}, "growing": {"grow_chunks": True}}
DEVICE_FIELDS = tuple(f"utterances.*.{plan}.{k}" for plan in PLANS
                      for k in ("device_busy_ms", "device_busy_share"))


def run_stream(module, z, sid, audio_s, reps, device, **kw) -> dict:
    for _ in module.stream_from_latents(z, sid, **kw):  # warm every shape
        pass
    ttfa, totals, n_chunks = [], [], 0
    for _ in range(reps):
        t0 = time.perf_counter()
        first, n_chunks = None, 0
        for _ in module.stream_from_latents(z, sid, **kw):
            if first is None:
                first = time.perf_counter() - t0
            n_chunks += 1
        totals.append(time.perf_counter() - t0)
        ttfa.append(first)
    total = statistics.median(totals)
    prof = timing.busy(
        lambda: list(module.stream_from_latents(z, sid, **kw)), device)
    return {"ttfa_ms": statistics.median(ttfa) * 1e3, "total_ms": total * 1e3,
            "stream_rtf": total / audio_s, "chunks": n_chunks,
            "device_busy_ms": prof["device_busy_ms"],
            "device_busy_share": prof["device_busy_share"]}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=CONFIG)
    p.add_argument("--reps", type=int, default=5)
    timing.add_device_argument(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = timing.tool_device(args.device)
    module = serving_module(args.config, device)
    utterances = {}
    for n in (1, 3):
        z, y_len, sid = module.prepare_shared_latents(SENTENCE * n, seed=0)
        audio_s = y_len * module.hop_length / module.sampling_rate
        utterances[f"x{n}"] = {"audio_s": audio_s, "z_frames": z.shape[0], **{
            plan: run_stream(module, z, sid, audio_s, args.reps, device, **kw)
            for plan, kw in PLANS.items()}}
    timing.emit({"metric": "streaming_decode", "utterances": utterances,
                 "reps": args.reps}, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
