"""Speed-of-light accounting of the train step and the serving forward
(the JAX package's `scripts/flops_analysis.py`): the FLOPs and bytes of
the step's generator forward, its D step and its G step as the port
splits them (`train/step.py`: one forward shared by both halves, so it
is counted once, where the port computes it), of the whole step, and of
`Synthesizer.infer` at `--infer-frames`, with the decoder head's part
of it (`infer.decoder`: its kind and GFLOP); each against the card's
peaks. Prints ONE JSON line.

    python -m mb_istft_vits_torch.flops_analysis [--batch 32] \
        [--infer-frames 512] [--peak-tflops T] [--hbm-gbps 3350] \
        [--device cpu | --cpu]

FLOPs are `torch.utils.flop_counter`'s (the matmul, convolution and
attention ops, forward and backward), bytes a dispatch mode's count of
each aten op's operands and results: the pre-fusion upper bound that
XLA's "bytes accessed" is (`utils.timing.count`). `sol_ms` is the FLOPs
at `--peak-tflops` (default: the peak of the step's precision,
`utils.timing.peak_for`), `bw_ms` the bytes at `--hbm-gbps` (default
the H100's 3,350). As in the JAX script the step runs bf16
(`fp16_run`). Counting runs the program, so it runs on the card; `--cpu`
(or `--device cpu`) counts on the CPU, where the JAX script lowers
without running and defaults to the CPU. The counts are the same on
both.
"""

from __future__ import annotations

import argparse
import sys

import torch

from mb_istft_vits_torch.bench import CONFIG
from mb_istft_vits_torch.bench_train import (load_config, step_precision,
                                             synthetic_batch, to_device)
from mb_istft_vits_torch.utils import timing

DEVICE_FIELDS = ()  # counts and bounds from the peaks: no device time
TOP_MODULES = 12


def count_step(state, batch) -> dict:
    """Counts of one train step in the port's three parts: the batch prep
    and generator forward, the D step, the G step."""
    from mb_istft_vits_torch.train import step as tstep

    res = {}

    def forward():
        res["prepped"] = prepped = tstep.prep_batch(batch, state.cfg)
        res["out"] = out = tstep.g_forward(state, prepped)
        res["y"] = tstep.real_slice(state, prepped, out[4])

    parts = {"forward": timing.count(forward)}
    prepped, out, y = res["prepped"], res["out"], res["y"]
    parts["d_step"] = timing.count(
        lambda: tstep.d_step(state, y, out[0].transpose(1, 2)))
    parts["g_step"] = timing.count(
        lambda: tstep.g_step(state, prepped, out, y))
    state.step += 1
    return parts


def count_infer(cfg, device, x, x_lengths, frames: int) -> dict:
    """Counts of `Synthesizer.infer` on one row at `frames` frames, with
    the name its decoder's counts are kept under (`decoder`)."""
    from mb_istft_vits_torch.models import Synthesizer

    torch.manual_seed(0)
    model = Synthesizer(cfg.model).to(device).eval()
    gen = torch.Generator(device).manual_seed(0)
    with torch.no_grad():
        counts = timing.count(lambda: model.infer(
            x, x_lengths, max_frames=frames, generator=gen))
    # infer is a method, so each module is kept under its class's name
    counts["decoder"] = type(model.dec).__name__
    return counts


def top_modules(counts: dict) -> dict:
    """The modules with the most forward FLOPs (GFLOP), the whole
    program's row dropped."""
    flat = {mod: sum(ops.values()) / 1e9
            for mod, ops in counts["by_module"].items() if mod != "Global"}
    return dict(sorted(flat.items(), key=lambda kv: -kv[1])[:TOP_MODULES])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=CONFIG)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--spec-frames", type=int, default=400)
    p.add_argument("--text-len", type=int, default=192)
    p.add_argument("--infer-frames", type=int, default=512)
    p.add_argument("--peak-tflops", type=float, default=None,
                   help="peak TFLOP/s for the speed-of-light column "
                        "(default: the H100's for the step's precision)")
    p.add_argument("--hbm-gbps", type=float,
                   default=timing.HBM_BYTES_PER_S / 1e9,
                   help="HBM GB/s for the roofline column (H100: 3350)")
    p.add_argument("--cpu", action="store_true",
                   help="count on the CPU (the same as --device cpu)")
    timing.add_device_argument(p)
    return p


def main(argv=None) -> int:
    from mb_istft_vits_torch.train.step import create_train_state

    args = build_parser().parse_args(argv)
    device = timing.tool_device("cpu" if args.cpu else args.device)
    cfg = load_config(args.config, args.batch, bf16=True)
    batch = to_device(synthetic_batch(cfg, args.batch, args.spec_frames,
                                      args.text_len, device_spec=True),
                      device)
    state = create_train_state(cfg, device, seed=0)
    precision, peak = step_precision(cfg, device)
    if args.peak_tflops is not None:
        precision, peak = "given", args.peak_tflops * 1e12
    hbm = args.hbm_gbps * 1e9

    parts = count_step(state, batch)
    parts["train_step_total"] = {
        k: sum(parts[p][k] for p in ("forward", "d_step", "g_step"))
        for k in ("flops", "bytes")}
    out = {name: timing.speed_of_light(c["flops"], c["bytes"], peak, hbm)
           for name, c in parts.items()}
    out["forward"]["top_modules"] = top_modules(parts["forward"])
    infer = count_infer(cfg, device, batch["x"][:1], batch["x_lengths"][:1],
                        args.infer_frames)
    audio_s = args.infer_frames * cfg.data.hop_length / cfg.data.sampling_rate
    out["infer"] = {**timing.speed_of_light(infer["flops"], infer["bytes"],
                                            peak, hbm),
                    "frames": args.infer_frames, "audio_s": audio_s,
                    "top_modules": top_modules(infer)}
    out["infer"]["rtf_floor"] = out["infer"]["sol_ms"] / 1e3 / audio_s
    # the decoder head's part: VITS's HiFi-GAN or one of the iSTFT heads
    out["infer"]["decoder"] = {
        "kind": cfg.model.decoder_kind,
        "gflop": sum(infer["by_module"][infer["decoder"]].values()) / 1e9}
    timing.emit({"metric": "flops_analysis", "batch": args.batch,
                 "spec_frames": args.spec_frames, "text_len": args.text_len,
                 "precision": precision, "peak_tflops": peak / 1e12,
                 "hbm_gbps": args.hbm_gbps, **out}, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
