#!/usr/bin/env python3
"""Drive the PyTorch port (mb_istft_vits_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:
  device   the card (torch and nvidia-smi)
  build    nvcc builds the MAS kernels from mb_istft_vits_torch/csrc;
           fails if ptxas reports a spill in any MAS kernel;
           counts the SASS instructions of each DP kernel's row loop and
           of mas_bwd's window loop (32 rows); fails unless a mas_bwd
           backtrack block leaves its SM no room for a path-writer block
  kernels  each MAS kernel against its plain PyTorch version, bit for bit,
           at the training shapes [64,400,200] [32,400,200] [64,800,380]
           [8,1000,380] (ragged lengths, t_x == 1 and t_y == t_x items),
           both the fused and the two-pass route; per kernel the call time
           (`ms`, CUDA events around the Python call) and the kernel's own
           device time (`kernel_ms`, a burst of calls queued behind a
           sleep); then mas_fwd's time per row against chunks per lane,
           and mas_bwd's time against rows and path cells
  serve    flagship config, seeded random weights: several requests of
           cleaned IPA text -> int16 PCM
  forward  flagship generator training forward on a batch of 16, once on
           the fused MAS kernel and once on the two-pass pair
Then one {"kernels": [...]} line (launch counts from the serve + forward
run, times, bounds; `launches` counts the first kernel of a port and
`launches_by_kernel` each of its kernels: mas_bwd is mas_bwd_kernel and
mas_path_kernel), the card's name and power limit as nvidia-smi prints
them, and last {"ok": true, "device": {...}}.

Any failed phase raises: the script exits non-zero and prints no result
line. It needs no network, starts no process that outlives it, and
imports nothing of JAX or of mb_istft_vits_tpu.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "ljs_mb_istft_vits.json")
FILELIST = os.path.join(REPO, "filelists",
                        "ljs_audio_text_test_filelist.txt.cleaned")
SOURCE = "mb_istft_vits_torch/csrc/mas.cu"
REPLACES = {
    "mas_fused": "mb_istft_vits_tpu/ops/mas_pallas.py:56",
    "mas_fwd": "mb_istft_vits_tpu/ops/mas_pallas.py:147",
    "mas_bwd": "mb_istft_vits_tpu/ops/mas_pallas.py:175",
}
# the launch counts (ops/mas.py) of each port's kernels
KERNELS_OF = {"mas_fused": ("mas_fused",), "mas_fwd": ("mas_fwd",),
              "mas_bwd": ("mas_bwd", "mas_path")}
# the MAS kernels as ptxas and cuobjdump name them, each with the SASS ops
# that mark its main loop: the DP's row loop (ballot, cp.async) and
# mas_bwd's window loop (shuffles, loads); none of them may spill
LOOP_OPS = {"mas_fused_kernel": ("VOTE", "LDGSTS"),
            "mas_fwd_kernel": ("VOTE", "LDGSTS"),
            "mas_bwd_kernel": ("SHFL", "LDG")}
SPILL_CHECKED = (*LOOP_OPS, "mas_path_kernel")
# mas_fwd at T_x = 32 K for each one-warp instantiation K: time per row
# against the chunks per lane
ROW_SCAN = [(16, 800, 128), (16, 800, 256), (16, 800, 384), (16, 800, 512)]
# mas_bwd against rows (t_y at T_x = 365) and path cells (T_x at T_y = 800)
BWD_SCAN = [(16, 400, 365), (16, 800, 365), (16, 1600, 365), (16, 800, 128),
            (16, 800, 1024)]
KERNEL_SHAPES = [(64, 400, 200), (32, 400, 200), (64, 800, 380),
                 (8, 1000, 380)]
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
REPS = 10


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_time_ms(fn, reps: int = 2 * REPS, bursts: int = 3) -> float:
    """Device time of one call of fn, the wrapper's host work (allocation,
    checks, the ctypes call) left out: the stream first sleeps, so the host
    queues `reps` calls before the first one runs and the card runs them
    back to back; CUDA events time the burst. Median over `bursts`."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(bursts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # ~50 ms: longer than queueing reps
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def band_cells(t_ys, t_xs) -> int:
    """DP cells inside every item's band: the cells of neg_cent the DP
    needs, max(0, t_x + y - t_y) <= x < min(t_x, y + 1) for y < t_y."""
    total = 0
    for t_y, t_x in zip(t_ys, t_xs):
        for y in range(t_y):
            total += max(0, min(t_x, y + 1) - max(0, t_x + y - t_y))
    return total


def bounds_ms(b, t_y_max, t_x_max, t_ys, t_xs):
    """Least time for each kernel's work: bytes each input is read once
    and each output written once (data-dependent parts counted for these
    lengths) over HBM bandwidth, vs ~4 float ops per band cell over the
    float32 peak. Returns {kernel: (bound_ms, bound_by)}."""
    cells = band_cells(t_ys, t_xs)
    words = (t_x_max + 31) // 32
    path_bytes = 4 * b * t_y_max * t_x_max
    len_bytes = 8 * b
    by_kernel = {
        "mas_fused": 4 * cells + path_bytes + len_bytes,
        "mas_fwd": 4 * cells + 4 * words * sum(t_ys) + len_bytes,
        # the backtrack needs one decision word per emitted row
        "mas_bwd": 4 * sum(t_ys) + path_bytes + len_bytes,
    }
    ops = {"mas_fused": 4 * cells, "mas_fwd": 4 * cells, "mas_bwd": 0}
    out = {}
    for name, nbytes in by_kernel.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops[name] / FP32_OPS_PER_S * 1e3
        out[name] = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
    return out


def ragged_problem(shape, seed):
    """Random f32 neg_cent on the card with ragged lengths: item 0 full,
    item 1 t_x == 1, item 2 t_y == t_x, the rest random with t_y >= t_x."""
    import torch

    from mb_istft_vits_torch.ops.mas import mas_lengths

    b, t_y, t_x = shape
    gen = torch.Generator().manual_seed(seed)
    t_xs = torch.randint(max(1, t_x // 2), t_x + 1, (b,), generator=gen)
    t_ys = torch.maximum(torch.randint(t_y // 2, t_y + 1, (b,), generator=gen),
                         t_xs)
    t_xs[0], t_ys[0] = t_x, t_y
    if b > 1:
        t_xs[1] = 1
    if b > 2:
        t_ys[2] = t_xs[2]
    neg_cent = (torch.randn(shape, generator=gen) * 3).cuda()
    mask = ((torch.arange(t_y)[None, :, None] < t_ys[:, None, None])
            & (torch.arange(t_x)[None, None, :] < t_xs[:, None, None])
            ).float().cuda()
    lengths = mas_lengths(mask)
    return neg_cent, mask, lengths


def check_kernels(neg_cent, mask, lengths):
    """Every MAS kernel against its plain version on the same inputs.
    Returns {kernel: {shape, bit_exact, max_abs_err, ms, kernel_ms,
    us_per_row, plain_ms, bound_ms, bound_by}}."""
    import torch

    from mb_istft_vits_torch.ops import mas

    t_ys, t_xs = lengths
    b, t_y, t_x = neg_cent.shape
    nc = (neg_cent * mask).contiguous()
    dec = mas.mas_decisions_plain(nc, t_ys, t_xs)
    path = mas.mas_backtrack_plain(dec, t_ys, t_xs)
    rows = (torch.arange(t_y, device=nc.device)[None, :, None]
            < t_ys.long()[:, None, None])  # decision rows the kernels write

    fused = mas.mas_fused(nc, t_ys, t_xs)
    bits = mas.mas_forward_bits(nc, t_ys, t_xs)
    bwd = mas.mas_backtrack(mas.pack_decisions(dec), t_ys, t_xs, t_x)
    chained = {f: mas.maximum_path(neg_cent, mask, impl="kernel", force=f)
               for f in ("fused", "two_pass")}
    torch.cuda.synchronize()
    fwd_dec = mas.unpack_decisions(bits, t_x)
    results = {
        "mas_fused": (torch.equal(fused, path)
                      and torch.equal(chained["fused"], path),
                      (fused - path).abs().max()),
        "mas_fwd": (torch.equal(fwd_dec & rows, dec & rows),
                    ((fwd_dec & rows) != (dec & rows)).float().max()),
        "mas_bwd": (torch.equal(bwd, path)
                    and torch.equal(chained["two_pass"], path),
                    (bwd - path).abs().max()),
    }
    bounds = bounds_ms(b, t_y, t_x, t_ys.tolist(), t_xs.tolist())
    packed = mas.pack_decisions(dec)
    timers = {
        "mas_fused": (lambda: mas.mas_fused(nc, t_ys, t_xs),
                      lambda: mas.mas_backtrack_plain(
                          mas.mas_decisions_plain(nc, t_ys, t_xs), t_ys, t_xs)),
        "mas_fwd": (lambda: mas.mas_forward_bits(nc, t_ys, t_xs),
                    lambda: mas.mas_decisions_plain(nc, t_ys, t_xs)),
        "mas_bwd": (lambda: mas.mas_backtrack(packed, t_ys, t_xs, t_x),
                    lambda: mas.mas_backtrack_plain(dec, t_ys, t_xs)),
    }
    out = {}
    for name, (exact, err) in results.items():
        row = {"shape": [b, t_y, t_x], "bit_exact": bool(exact),
               "max_abs_err": float(err), "bound_ms": bounds[name][0],
               "bound_by": bounds[name][1]}
        kernel_fn, plain_fn = timers[name]
        row["ms"] = time_ms(kernel_fn)
        row["kernel_ms"] = kernel_time_ms(kernel_fn)
        row["us_per_row"] = row["kernel_ms"] * 1e3 / t_y
        row["plain_ms"] = time_ms(plain_fn)
        out[name] = row
    return out


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)
    return smi


def sass_loop_lengths():
    """{kernel instantiation: SASS instructions in its main loop, the
    shortest loop that holds the kernel's LOOP_OPS} from cuobjdump of the
    built library."""
    from mb_istft_vits_torch import kernels

    cuobjdump = os.path.join(os.path.dirname(kernels.find_nvcc()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", kernels.library_path()],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    lengths = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = re.search(r"(mas_[a-z]+_kernel)(?:I(\w*?)EEv)?",
                         block.split("\n")[0])
        if not name or name.group(1) not in LOOP_OPS:
            continue
        code = [(int(a, 16), op) for a, op in
                re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        addrs = [a for a, _ in code]
        loops = []
        for i, (addr, op) in enumerate(code):
            back = re.search(r"BRA (0x[0-9a-f]+)", op)
            if not back or int(back.group(1), 16) >= addr:
                continue
            body = " ".join(o for _, o in
                            code[addrs.index(int(back.group(1), 16)):i + 1])
            if all(op in body for op in LOOP_OPS[name.group(1)]):
                loops.append(i + 1 - addrs.index(int(back.group(1), 16)))
        args = ",".join(re.findall(r"L[ib](\d+)E", name.group(2) or ""))
        lengths[f"{name.group(1)}<{args}>"] = min(loops) if loops else None
    return lengths


def phase_build():
    from mb_istft_vits_torch import kernels

    t0 = time.perf_counter()
    report = kernels.build()
    lib = kernels.library()
    # every instantiation of these kernels must keep its arrays in registers
    spills = {name: s for name, s in kernels.ptxas_spills(report).items()
              if any(k in name for k in SPILL_CHECKED)}
    owns_sm = lib.mas_bwd_owns_sm(0)
    emit("build", seconds=time.perf_counter() - t0,
         library=os.path.relpath(kernels.library_path(), REPO),
         max_shared_bytes=lib.mas_max_shared_bytes(0),
         mas_bwd_owns_sm=owns_sm,
         spill_bytes=spills, loop_instructions=sass_loop_lengths(),
         ptxas=[line.strip() for line in report
                if "registers" in line or "Compiling entry" in line])
    missing = [k for k in SPILL_CHECKED if not any(k in n for n in spills)]
    if missing or any(s != (0, 0) for s in spills.values()):
        raise AssertionError(f"kernels spill or are missing: {spills}")
    if owns_sm != 1:
        raise AssertionError("a path-writer block fits beside a mas_bwd "
                             f"backtrack block (mas_bwd_owns_sm={owns_sm})")


def phase_kernels():
    import torch

    from mb_istft_vits_torch.ops import mas

    rows = []
    for i, shape in enumerate(KERNEL_SHAPES):
        neg_cent, mask, lengths = ragged_problem(shape, seed=i)
        auto = "fused" if mas.fused_fits(shape[1], shape[2],
                                         neg_cent.device) else "two_pass"
        res = check_kernels(neg_cent, mask, lengths)
        for name, row in res.items():
            rows.append({"name": name, "auto_route": auto, **row})
            if not row["bit_exact"]:
                raise AssertionError(f"{name} differs from the plain version "
                                     f"at {list(shape)}: {row}")
        del neg_cent, mask
        torch.cuda.empty_cache()
    scan = []
    for i, shape in enumerate(ROW_SCAN):
        neg_cent, mask, (t_ys, t_xs) = ragged_problem(shape, seed=10 + i)
        nc = (neg_cent * mask).contiguous()
        ms = kernel_time_ms(lambda: mas.mas_forward_bits(nc, t_ys, t_xs))
        scan.append({"shape": list(shape), "chunks_per_lane": shape[2] // 32,
                     "kernel_ms": ms, "us_per_row": ms * 1e3 / shape[1]})
    # least squares us_per_row = fixed + per_chunk * chunks: the part of a
    # row that does not grow with its columns, and the part that does
    per_chunk, fixed = statistics.linear_regression(
        [r["chunks_per_lane"] for r in scan], [r["us_per_row"] for r in scan])
    fit = {"us_per_row_fixed": fixed, "us_per_chunk": per_chunk}
    bwd_scan, bwd_fit = mas_bwd_scan()
    emit("kernels", checks=rows, mas_fwd_row_scan=scan, mas_fwd_row_fit=fit,
         mas_bwd_scan=bwd_scan, mas_bwd_fit=bwd_fit)
    return rows


def mas_bwd_scan():
    """mas_bwd's own time at BWD_SCAN, each backtracking the decisions of
    mas_fwd on a ragged problem (item 0 full), and the least-squares split
    kernel_ms = fixed + per_row * T_y + per_cell * T_y * T_x of one item:
    the backtrack's rows and the path slab's cells."""
    import numpy as np
    import torch

    from mb_istft_vits_torch.ops import mas

    scan = []
    for i, shape in enumerate(BWD_SCAN):
        neg_cent, mask, (t_ys, t_xs) = ragged_problem(shape, seed=20 + i)
        bits = mas.mas_forward_bits((neg_cent * mask).contiguous(), t_ys, t_xs)
        ms = kernel_time_ms(lambda: mas.mas_backtrack(bits, t_ys, t_xs,
                                                      shape[2]))
        scan.append({"shape": list(shape), "kernel_ms": ms,
                     "us_per_row": ms * 1e3 / shape[1]})
        del neg_cent, mask, bits
    torch.cuda.empty_cache()
    terms = np.array([[1.0, t_y, t_y * t_x] for _, t_y, t_x in BWD_SCAN])
    (fixed, per_row, per_cell), *_ = np.linalg.lstsq(
        terms, np.array([r["kernel_ms"] for r in scan]), rcond=None)
    return scan, {"us_fixed": fixed * 1e3, "ns_per_row": per_row * 1e6,
                  "ns_per_cell": per_cell * 1e6}


def _texts(n: int):
    with open(FILELIST, encoding="utf-8") as f:
        return [line.rstrip("\n").split("|")[-1] for line in f][:n]


def profile_call(fn):
    """fn() under torch.profiler: wall time, summed device time (busy share
    of the wall), top device kernels and top host ops. fn must end in a
    device sync."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device rows are the kernels, copies and memsets themselves; an op's
    # own row repeats its kernels' time, so only these are summed
    dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
           if e.device_type == DeviceType.CUDA]
    host = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in events
            if e.device_type == DeviceType.CPU]
    device_ms = sum(d[1] for d in dev)

    def top(rows):
        return [{"name": k[:80], "ms": ms, "calls": c}
                for k, ms, c in sorted(rows, key=lambda r: -r[1])[:6]]

    return {"wall_ms_profiled": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms if dev else None,
            "top_device": top(dev), "top_host": top(host)}


def phase_serve():
    import numpy as np

    from mb_istft_vits_torch.infer.synthesis import SynthesisModule

    sm = SynthesisModule(CONFIG, seed=0, device="cuda")
    texts = _texts(6)
    cold_pcm, cold = sm.synthesize(texts[0], seed=0)  # cuDNN/cuBLAS set-up
    requests = []
    for i, text in enumerate(texts[:5]):
        pcm, tm = sm.synthesize(text, seed=i)
        frames = int(tm["frames"])
        if pcm.dtype != np.int16 or pcm.shape != (frames * sm.hop_length,):
            raise AssertionError(f"request {i}: {pcm.dtype} {pcm.shape}, "
                                 f"{frames} frames")
        rms = float(np.sqrt(np.mean(pcm.astype(np.float64) ** 2)))
        if not rms > 0:
            raise AssertionError(f"request {i}: silent output")
        requests.append({"tokens": int(sm.text_to_ids(text).size),
                         "frames": frames, "samples": int(pcm.size),
                         "rms": rms, "audio_seconds": tm["audio_seconds"],
                         "total": tm["total"], "rtf": tm["rtf"]})
    # the same text again: every op sees shapes it has seen before
    _, again = sm.synthesize(texts[1], seed=1)
    emit("serve", config=os.path.relpath(CONFIG, REPO), weights="random",
         cold_request={"total": cold["total"], "rtf": cold["rtf"]},
         requests=requests,
         median_rtf=statistics.median(r["rtf"] for r in requests),
         repeat_request={"total": again["total"], "rtf": again["rtf"]},
         profile_new_shapes=profile_call(lambda: sm.synthesize(texts[5])),
         profile_repeat=profile_call(lambda: sm.synthesize(texts[1])))


def phase_forward():
    """Flagship training forward, batch 16: returns the MAS inputs of the
    run for the kernels' main-path timing."""
    import torch

    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.models import Synthesizer
    from mb_istft_vits_torch.models.synthesizer import mas_neg_cent
    from mb_istft_vits_torch.ops import mas
    from mb_istft_vits_torch.text import frontend_ids

    config = Config.from_json(CONFIG)
    cfg, d = config.model, config.data
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        model = Synthesizer(cfg)
    model = model.cuda().eval()  # eval: no dropout, so enc_p re-runs equal
    b = 16
    ids = sorted((frontend_ids(text, d.text_module, d.text_cleaners,
                               d.add_blank, d.cleaned_text)
                  for text in _texts(500)), key=len)[-b:]
    t_x = max(len(i) for i in ids)
    x = torch.zeros((b, t_x), dtype=torch.long)
    for i, seq in enumerate(ids):
        x[i, :len(seq)] = torch.tensor(seq)
    x_lengths = torch.tensor([len(s) for s in ids])
    gen = torch.Generator().manual_seed(2)
    y_lengths = torch.maximum(torch.randint(400, 801, (b,), generator=gen),
                              x_lengths)
    y_lengths[0] = 800
    t_y = int(y_lengths.max())
    y = torch.log(torch.randn((b, t_y, cfg.spec_channels),
                              generator=gen) ** 2 + 1e-5)
    eps = torch.randn((b, t_y, cfg.inter_channels), generator=gen)
    ids_slice = (torch.rand(b, generator=gen)
                 * (y_lengths - cfg.segment_size + 1)).to(torch.int32)
    x, x_lengths, y, y_lengths, eps, ids_slice = (
        v.cuda() for v in (x, x_lengths, y, y_lengths, eps, ids_slice))

    def run(force):
        with torch.no_grad():
            out = model(x, x_lengths, y, y_lengths, posterior_eps=eps,
                        ids_slice=ids_slice, mas_force=force)
        torch.cuda.synchronize()
        return out

    run("auto")  # warm-up: cuDNN algorithm choice, kernel library load
    timings = {}
    for force in ("auto", "two_pass"):
        t0 = time.perf_counter()
        out = run(force)
        timings[force] = time.perf_counter() - t0
        if force == "auto":
            fused_out = out
    o, o_mb, l_length, attn, _, x_mask, y_mask, latents = fused_out
    if not torch.equal(out[3], attn):
        raise AssertionError("fused and two-pass MAS disagree in forward")

    with torch.no_grad():
        _, m_p, logs_p, _ = model.enc_p(x, x_lengths)
        neg_cent = mas_neg_cent(latents[1].transpose(1, 2), m_p, logs_p)
    mask = (y_mask * x_mask.transpose(1, 2)).float()
    plain = mas.maximum_path(neg_cent, mask, impl="plain")
    checks = {
        "attn_equals_plain": torch.equal(attn, plain),
        "attn_rows_sum_to_mask": torch.equal(attn.sum(-1), y_mask[..., 0]),
        "l_length_finite": bool(torch.isfinite(l_length).all()),
        "o_finite": bool(torch.isfinite(o).all()
                         and torch.isfinite(o_mb).all()),
        "o_shape": list(o.shape) == [b, cfg.segment_size * 256, 1],
    }
    emit("forward", batch=b, t_x_max=t_x, t_y_max=t_y,
         seconds_fused=timings["auto"], seconds_two_pass=timings["two_pass"],
         l_length_mean=float(l_length.mean()), checks=checks,
         # twice: the first may still grow the caching allocator
         profile_fused=profile_call(lambda: run("auto")),
         profile_fused_again=profile_call(lambda: run("auto")))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"training forward checks failed: {failed}")
    return neg_cent, mask


def main() -> int:
    smi = phase_device()
    sys.path.insert(0, REPO)
    import torch

    from mb_istft_vits_torch.device import disable_tf32
    from mb_istft_vits_torch.ops import mas

    disable_tf32()
    phase_build()
    checks = phase_kernels()

    # the main path: serving, then the training forward; the counts show
    # which kernels it launched
    mas.reset_launch_counts()
    phase_serve()
    neg_cent, mask = phase_forward()
    launches = dict(mas.launch_counts)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")

    # headline numbers: the kernels on the training forward's own inputs
    main_rows = check_kernels(neg_cent, mask, mas.mas_lengths(mask))
    kernels = []
    for name, row in main_rows.items():
        if not row["bit_exact"]:
            raise AssertionError(f"{name} differs on the forward's inputs")
        shapes = [c for c in checks if c["name"] == name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "launches_by_kernel": {f"{k}_kernel": launches[k]
                                   for k in KERNELS_OF[name]},
            "shape": row["shape"], "bit_exact": all(
                [row["bit_exact"]] + [c["bit_exact"] for c in shapes]),
            "max_abs_err": max([row["max_abs_err"]]
                               + [c["max_abs_err"] for c in shapes]),
            "ms": row["ms"], "kernel_ms": row["kernel_ms"],
            "us_per_row": row["us_per_row"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shapes": [{k: c[k] for k in ("shape", "auto_route", "ms",
                                          "kernel_ms", "us_per_row",
                                          "plain_ms", "bound_ms",
                                          "bit_exact")} for c in shapes],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
