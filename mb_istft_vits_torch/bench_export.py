"""The exported serving artifact against the live module (the JAX
package's `scripts/bench_export.py`): `infer/export.py`'s programs for the
headline sentence's (text, frame) bucket pair, then the same sentence
through `SynthesisModule.synthesize` and `ExportedServing.synthesize`.
Prints ONE JSON line.

    python -m mb_istft_vits_torch.bench_export [--reps 12] [--device cpu]

Reports the median end-to-end RTF of each (host clock), the device RTF
of each one's infer program (the card's own time of a call, the union of
its device activity, `utils.timing.busy_median_ms`; null on the CPU),
the artifact's determinism across runs (max |a - b| of two seeded
requests), how far live and exported audio lie apart, and the export and
load seconds. The artifact goes to MBIV_EXPORT_DIR when it is set, else
to a temporary directory removed at the end. bf16 on the card, float32
on the CPU, random weights from a seed.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time

import numpy as np

from mb_istft_vits_torch.bench import (CONFIG, KNOBS, TEXT, headline,
                                       infer_call, serving_module)
from mb_istft_vits_torch.utils import timing

DEVICE_FIELDS = ("rtf_device_live", "rtf_device_exported")


def median_e2e(synth, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        synth()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def exported_call(served, module, bucket: int):
    """The artifact's infer program on the headline's device inputs, as
    `ExportedServing.synthesize` runs it (seed 0, the default knobs)."""
    import torch

    from mb_istft_vits_torch.infer.export import _scalar

    x, xl = module._pad_ids_cached(module.text_to_ids(TEXT))
    program = served._infer[(x.shape[1], bucket)]
    knobs = [_scalar(v) for v in KNOBS]

    def call():
        gen = torch.Generator(served.device).manual_seed(0)
        eps = torch.randn((1, served.manifest["inter_channels"], bucket),
                          generator=gen, dtype=served.compute_dtype,
                          device=served.device).transpose(1, 2).contiguous()
        with torch.no_grad():
            return program(served.params, x, xl, None, *knobs, eps, None)[0]

    return call


def run(module, out_dir: str, reps: int, device) -> dict:
    from mb_istft_vits_torch.infer.export import export_serving, load_serving
    from mb_istft_vits_torch.infer.synthesis import _next_bucket

    secs, bucket, _ = headline(module)
    tb = _next_bucket(len(module.text_to_ids(TEXT)), module.TEXT_BUCKETS)
    t0 = time.perf_counter()
    export_serving(module, out_dir, pairs=[(tb, bucket)])
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = load_serving(out_dir, device=device)
    audio_exp, _ = served.synthesize(TEXT, seed=0)
    t_load = time.perf_counter() - t0

    audio_exp2, _ = served.synthesize(TEXT, seed=0)
    audio_live, _ = module.synthesize(TEXT, seed=0)
    n = min(len(audio_live), len(audio_exp))
    e2e_live = median_e2e(lambda: module.synthesize(TEXT, seed=0), reps)
    e2e_exp = median_e2e(lambda: served.synthesize(TEXT, seed=0), reps)
    dev_live = timing.busy_median_ms(infer_call(module, TEXT, bucket),
                                     device)
    dev_exp = timing.busy_median_ms(exported_call(served, module, bucket),
                                    device)
    return {
        "metric": "export_vs_live_e2e",
        "rtf_e2e_live": e2e_live / secs,
        "rtf_e2e_exported": e2e_exp / secs,
        "exported_over_live": e2e_exp / max(e2e_live, 1e-9),
        "rtf_device_live": None if dev_live is None else dev_live / 1e3 / secs,
        "rtf_device_exported": None if dev_exp is None
        else dev_exp / 1e3 / secs,
        "artifact_determinism_delta": float(np.max(np.abs(
            audio_exp - audio_exp2[: len(audio_exp)]))),
        "live_vs_exported_delta": float(np.max(np.abs(
            audio_live[:n] - audio_exp[:n]))),
        "export_s": t_export,
        "load_compile_s": t_load,
        "audio_seconds": secs,
        "frame_bucket": bucket,
        "artifact_dir": out_dir,
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=CONFIG)
    p.add_argument("--reps", type=int, default=12,
                   help="timed requests of each of live and artifact")
    timing.add_device_argument(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = timing.tool_device(args.device)
    module = serving_module(args.config, device)
    out_dir = os.environ.get("MBIV_EXPORT_DIR")
    if out_dir:
        result = run(module, out_dir, args.reps, device)
    else:
        with tempfile.TemporaryDirectory(prefix="mbiv_export_") as tmp:
            result = run(module, tmp, args.reps, device)
    timing.emit(result, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
