"""Dissect single-utterance synthesis (the JAX package's
`scripts/profile_infer.py`): the duration probe, the whole infer
program, the latents, the decode and the copy of the PCM to the host,
each in device ms (the card's own time of a call, the union of its
device activity, `utils.timing.busy_median_ms`; the copy by CUDA events
around a burst, `utils.timing.card_ms`; null on the CPU), the
end-to-end RTF against the device-only RTF (probe + infer over the
audio's seconds), and a stream's time to its first audio. Prints ONE
JSON line.

    python -m mb_istft_vits_torch.profile_infer [--device cpu]

bf16 on the card, float32 on the CPU, random weights from a seed.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from mb_istft_vits_torch.bench import CONFIG, KNOBS, TEXT, serving_module
from mb_istft_vits_torch.utils import timing

DEVICE_FIELDS = ("probe_ms", "infer_ms", "latents_ms", "decode_ms",
                 "host_copy_ms", "device_only_rtf")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=CONFIG)
    timing.add_device_argument(p)
    return p


def main(argv=None) -> int:
    from mb_istft_vits_torch.infer.synthesis import _next_bucket

    args = build_parser().parse_args(argv)
    device = timing.tool_device(args.device)
    module = serving_module(args.config, device)
    _, e2e = module.synthesize(TEXT, seed=0)
    ids = module.text_to_ids(TEXT)
    x, xl = module._pad_ids(ids)
    ns, ls, nsw = KNOBS
    gen, w_eps = module._draws(x.shape, 0)

    def probe():
        return module._predict_frames(x, xl, None, ls, nsw, w_eps)

    frames = int(probe()[0])
    bucket = _next_bucket(frames, module.FRAME_BUCKETS)
    audio_s = frames * module.hop_length / module.sampling_rate

    def infer():
        return module._infer(x, xl, None, ns, ls, nsw, bucket, gen, w_eps)

    def latents():
        return module._latents(x, xl, None, ns, ls, nsw, bucket, gen, w_eps)

    pcm16, _ = infer()
    z = latents()[0]
    host = torch.empty(pcm16.shape, dtype=pcm16.dtype,
                       pin_memory=device.type == "cuda")
    ms = {"probe_ms": timing.busy_median_ms(probe, device),
          "infer_ms": timing.busy_median_ms(infer, device),
          "latents_ms": timing.busy_median_ms(latents, device),
          "decode_ms": timing.busy_median_ms(
              lambda: module._decode_pcm(z), device),
          # one copy a call: the host queues a burst of them behind the
          # device's sleep, so CUDA events time the card's copies back to
          # back (the profiler missed some of these short copies)
          "host_copy_ms": timing.card_ms(
              lambda: host.copy_(pcm16, non_blocking=True), device)}

    # streaming: the time to the first audio (pipelined chunk decode)
    t0 = time.perf_counter()
    zs, _, sid = module.prepare_shared_latents(TEXT, seed=0)
    t_latents = time.perf_counter() - t0
    for _ in range(2):  # warm the chunk program
        list(module.stream_from_latents(zs[:96], sid, chunk_frames=64,
                                        overlap_frames=8))
    t0 = time.perf_counter()
    marks, total = [], 0
    for chunk in module.stream_from_latents(zs, sid, chunk_frames=64,
                                            overlap_frames=8):
        total += len(chunk)
        marks.append(time.perf_counter() - t0)
    stream_audio = total / module.sampling_rate

    on_card = ms["infer_ms"] is not None
    timing.emit({
        "metric": "infer_breakdown", "e2e": e2e, "tokens": len(ids),
        "text_bucket": int(x.shape[1]), "frames": frames,
        "frame_bucket": bucket, "audio_s": audio_s, **ms,
        "e2e_rtf": e2e["rtf"],
        "device_only_rtf": (ms["probe_ms"] + ms["infer_ms"]) / 1e3 / audio_s
        if on_card else None,
        "stream": {"latents_ms": t_latents * 1e3,
                   "first_audio_ms": marks[0] * 1e3, "chunks": len(marks),
                   "total_ms": marks[-1] * 1e3, "audio_s": stream_audio,
                   "stream_rtf": marks[-1] / stream_audio},
    }, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
