"""Chunked-decode strategies on an ~18 s utterance (the JAX package's
`scripts/bench_chunk_decode.py`): the pipelined streaming decode (one
decode a chunk, one chunk ahead, `synthesize_from_shared_latents`)
against `decode_chunks_batched` (every chunk in one decode), the two
spectrogram joins and the whole decode. Prints ONE JSON line.

    python -m mb_istft_vits_torch.bench_chunk_decode [--reps 5] \
        [--device cpu]

Each strategy's ms is the host-clock median of `--reps` calls, each
returning audio on the host; `device_busy_ms` is the union of one call's
device activity (torch.profiler), null on the CPU. bf16 on the card,
float32 on the CPU, random weights from a seed.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

from mb_istft_vits_torch.bench import CONFIG, serving_module
from mb_istft_vits_torch.bench_stream import SENTENCE
from mb_istft_vits_torch.utils import timing

STRATEGIES = ("streaming_pipelined", "batched_one_dispatch",
              "spec_join_pipelined", "spec_join_batched", "full_decode")
DEVICE_FIELDS = tuple(f"strategies.{s}.{k}" for s in STRATEGIES
                      for k in ("device_busy_ms", "device_busy_share"))


def strategies(module, z, sid) -> dict:
    chunk = {"chunk_frames": 256, "overlap_frames": 16}
    return {
        "streaming_pipelined":
            lambda: module.synthesize_from_shared_latents(z, sid, **chunk),
        "batched_one_dispatch":
            lambda: module.decode_chunks_batched(z, sid, **chunk),
        "spec_join_pipelined": lambda: module.decode_spec_join(z, sid, **chunk),
        "spec_join_batched":
            lambda: module.decode_spec_join(z, sid, batched=True, **chunk),
        "full_decode": lambda: module.infer_z_only(z, sid),
    }


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
    z, y_len, sid = module.prepare_shared_latents(SENTENCE * 3, seed=0)
    audio_s = y_len * module.hop_length / module.sampling_rate
    out = {}
    for name, fn in strategies(module, z, sid).items():
        fn()  # warm every shape
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            wav = fn()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        prof = timing.busy(fn, device)
        out[name] = {"ms": med * 1e3, "rtf": med / audio_s, "n": len(wav),
                     "device_busy_ms": prof["device_busy_ms"],
                     "device_busy_share": prof["device_busy_share"]}
    timing.emit({"metric": "chunked_decode", "latents": list(z.shape),
                 "audio_s": audio_s, "strategies": out, "reps": args.reps},
                device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
