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
  forward  flagship generator training forward on a batch of 16, once on
           the fused MAS kernel and once on the two-pass pair
  train    flagship GAN training steps (D step, then G step against the
           updated D) at batch 16 on seeded int16 audio, spectrogram on
           the card, through train_step, which runs the step's CUDA graph
           (eager warm-up steps, a capture, replays; each step's route
           reported): step times (the replays' median), the eager body's
           D/G split, peak memory, a profiled replay, a bf16 step; checks
           finite metrics, moved f32 weights, a falling mel loss, one MAS
           launch per step (a replay counts its capture's launches), the
           step's alignment against the plain MAS
  train_ms the Japanese 12-speaker multi-stream model
           (uudb_ms_istft_vits_ms.json) at full width, batch 16 of the 16
           longest UUDB rows (6 speakers), seeded 16 kHz audio: a first
           step, 4 timed steps, a profiled one; checks as `train`, plus
           loss/g/subband == 0 and emb_g's gradient on exactly the batch's
           speakers' rows; its step time over the flagship's
  train_sdp the flagship with the stochastic duration predictor (use_sdp,
           upstream VITS's ljs_base.json setting) on the train phase's
           batch: a first step, 3 timed steps, a profiled one, a bf16 one;
           checks as `train`, plus a finite loss/g/dur and every dp.* weight
           moved; its step and device time over the flagship's
  eval_ms  the trainer's evaluate() once at full width on train_ms's
           generator: 12 syntheses, copy synthesis, MCD / LSD / F0 and the
           TTS DTW MCD; its seconds and scalars
  train_graphs the training step as CUDA graphs per batch signature
           (train/graphs.py) against the eager body in this process, for
           the flagship at batch 16 in f32 and with fp16_run, the SDP
           model and the 12-speaker model: a replayed step against the
           eager step from the same weights, draws and dropout seed at the
           whole-step bars (lr 10, eps 10; past an epoch boundary, so the
           update reads the decayed lr 5 from the lr tensor): bit for bit
           under cuDNN's and torch's deterministic algorithms; under the
           default ones the losses and D leaves within the bars and the G
           updates, as one vector, within the G bar or 3x the eager
           step's distance from its own repeats; each profiled replay's
           MAS kernels on the card equal to the wrappers' counts; at the
           config's lr,
           the warm-up and capture (seconds, pool bytes), step ms of
           graphs and eager (host-synced and CUDA events), launches a warm
           step (one cudaGraphLaunch), busy share, MAS launches a step;
           for the flagship a second bucket captured once in the same
           pool, both replayed in turns, a resume that drops the graphs
           and captures again, and the two-pass MAS pair from a replay
  train_cli the training CLI at a shrunk width, an eval and a pair every 2
           steps: 10 steps, then --reset-optimizer to step 12 (evals in the
           log, best.json, pruning to the newest 3 and the best, metrics
           every log_interval, the epoch snap, fresh optimizers); then a
           child CLI run stopped by SIGTERM (a pair, exit code 0)
  train_data the flagship at full width and the config's own batch 64, fed
           from disk: LJSpeech lines rendered to wavs (utils/corpus.py), two
           buckets of two batches; one epoch in each feed through the
           trainer's iterator: device-spec int16 PCM, host spectrograms
           (.spec.npy written, then a second epoch reading them) and the
           corpus held on the card; checks the native loader path, every
           row's cache, host against card spectrograms, resident batches
           bit-equal to host ones, the pool's bytes, one MAS launch a step;
           step ms (and each step's route: eager warm-up, capture or
           replay, one graph per bucket and feed signature), batch wait
           and host-to-device bytes of each feed, the graphs' captures and
           pool bytes, a profiled replay, peak memory; saves the pair
  tools    the offline CLIs as child processes on the card: eval_checkpoint
           on train_data's pair (-n 4 --tts), eval_metrics, make_corpus and
           eval_vc (12-speaker config, random weights, 2 pairs),
           preprocess; exit codes 0 and finite scores
  ddp      data-parallel training through the stage graphs (a rank's step
           is 3 CUDA graphs with its 2 all-reduces run eagerly between
           them): two ranks spawned on cuda:0 over gloo
           (tests/torch_port_dist_worker.py), the flagship at full width, 8
           rows a rank (16 in all): a step on seeded global draws (lr 10,
           eps 10, every dropout off) at the whole-step bars of the CPU
           tests, with torch's own convolutions against the single-process
           step on the 16 rows, and with cuDNN's deterministic algorithms
           against the single-process sum of the two 8-row halves (cuDNN
           picks other algorithms for 8 rows than for 16: the 16-row
           step's distance is reported); then 4 timed steps at the
           config's lr (2 eager warm-ups, the capture, a replay); checks
           the ranks' weights bit-equal after every step, equal metrics,
           one MAS launch a rank a step; then a replayed step against the
           eager data-parallel step from the same weights and draws, bit
           for bit under cuDNN's and torch's deterministic algorithms and
           within the train_graphs phase's bars under the default ones;
           2 queued steps of each route timed with CUDA events and
           one warm step of each profiled: 3 graph launches and fewer than
           20 kernel launches a replayed rank step, its MAS kernels seen
           on the card; records each rank's step ms (one card shared: not
           a scaling number), the ms of an all-reduce of one buffer of
           every weight's bytes, outside the steps; the training CLI under
           `python -m torch.distributed.run --nproc_per_node 1` (NCCL,
           world 1): exit 0, a pair, a capture of 3 stages logged, step 1
           equal to the plain CLI's; and the error NCCL gives two ranks
           on one card
  tp       parallel.dryrun.dryrun_multichip(2) (two data-parallel ranks
           sharing the card over gloo, through the stage graphs: the tiny
           step, then the flagship half, the flagship in bf16 at 32 rows
           a rank, its warm-ups and capture, its capture memory a rank)
           beside the 2-D step at the flagship's widths: two ranks on
           cuda:0 over gloo as a (1 x 2) data x model mesh, 8 rows, the
           shards held by parallel/tp.py: a compared step held to the
           single-process step at the ddp bars; 4 timed steps (2 eager
           warm-ups, the capture of 5 stage graphs, a replay); a replay
           bit-equal to the eager 2-D step under the deterministic
           algorithms and within the train_graphs bars under the default
           ones; a warm rank step of 5 graph launches, 4 collectives and
           fewer than 25 kernel launches, its MAS kernels seen; the
           shards and moments shard-shaped as param_shardings says; a
           save and resume then a step equal to the uninterrupted step;
           a rank's step ms on the graphs and eager, busy share, capture
           s, pool bytes
  overfit  the JAX package's overfit gate (scripts/overfit_check.py) through
           the port's overfit_check.run in this process: the tiny
           multi-band config, 150 steps on one seeded batch; checks the
           mel loss below 0.7 of the first step's, finite losses, one MAS
           launch on the card a step; step ms, a profiled step
  surface  the library surface no shipped config runs, at the flagship's
           widths: TransformerDecoder [2,192,400] on a [2,192,160] memory,
           MultiHeadAttention with heads_share=False, block_length 4, the
           proximal bias and init, cross-attention, ConvReluNorm, the
           timing signals, each on the card against the CPU (max-abs <=
           1e-4; ms); utils.profile_trace around one flagship infer must
           write a trace naming a CUDA kernel
  bench    the measurement tools (python -m mb_istft_vits_torch.<tool>:
           bench, bench_train, bench_batch, bench_stream,
           bench_chunk_decode, bench_microbatch, bench_export, bench_mas,
           profile_step, profile_infer, flops_analysis) as child processes
           on the card at the flagship's widths, short repetitions; the
           three batch-64 train tools one after another, beside the others
           started together; checks each exit code 0, its JSON's device the
           card, every device field finite and > 0, bench_train's mfu in
           (0, 1.05]; each tool's MAS launches reported on its own, not
           as the main path's
  serve    flagship config, seeded random weights: warmup() of the default
           (text, frame) bucket pairs; 8 requests of filelist lines whose
           token counts warmup did not run (per request tokens, buckets,
           total, rtf, dispatch, sync), the same again, a profiled new
           text; the long-text split; synthesize_batch of 16 lines, also
           resampled to 16 kHz on the card; one latent through
           stream_from_latents (time to the first chunk),
           decode_chunks_batched and decode_spec_join (each correlated
           > 0.98 with the whole decode); the micro-batcher with 8
           concurrent callers (rows bit-equal to synthesize_batch); the
           streaming engine for one utterance, twice
  serve_graphs the serving programs as CUDA graphs (infer/graphs.py), for
           the flagship in f32 and in bf16, the 12-speaker model with
           speaker 5 and ljs_istft_vits.json: warmup() a pair at a time
           (capture seconds and graphs per pair, the pool's bytes); per
           warmup pair the infer and probe replays bit-equal to a direct
           call of the same body on the same inputs, at the default knobs
           and at others (no new capture); a seeded repeat bit-equal; a
           new decode shape captured once; for the flagship in each dtype,
           the headline sentence (mb_istft_vits_torch.bench's) and each
           warmup pair on the graphs against the direct eager call of the
           same bodies (today's launches): launches a request
           (cudaLaunchKernel, cudaGraphLaunch, copies), dispatch, sync, e2e
           RTF, the device busy union a call; mesh=[cuda:0, cuda:0]'s batch
           of 16 against the single device's (atol 5e-4)
  export   the exported serving artifact (infer/export.py) of the flagship:
           two (text, frame) pairs traced on the card, loaded with
           load_serving; 4 filelist texts bit-equal to the live module at
           their seeds and frame buckets, seeded repeats bit-equal,
           unseeded requests different, frames past every bucket
           refused; the artifact's programs replayed as CUDA graphs
           (infer/graphs.py), each request bit-equal to the artifact's
           eager call of the same programs; a pair traced on the CPU and
           served on cuda:0 (within one int16 step of the card-traced
           one); a bf16 pair against the live bf16 module (its distance
           reported); a 12-speaker pair, speakers 0 and 5, bit-equal to
           its live module; export and load seconds, the bytes of
           params.pt and each .pt2 (each under a tenth of the weights),
           the median RTF of 12 requests and the launches a request (two
           graph launches in the artifact's), live against artifact
           against the artifact's eager call
  serve_ms the 12-speaker model of train_ms: warmup(), 4 UUDB rows as
           requests of speakers 0 and 11 (different PCM), one profiled, a
           seeded repeat at one bucket (bit-equal); synthesize_batch of 16
           rows of mixed speakers, twice (bit-equal); stream_from_latents
           and decode_spec_join of one latent of speaker 5 (correlated >
           0.98 with the whole decode); the micro-batcher with 8 callers of
           8 speakers (each row its own speaker's); the voice-conversion
           CLI, speaker 0 -> 5, in this process
  serve_istft the single-band iSTFT model (ljs_istft_vits.json):
           warmup(), 4 requests, one profiled, decode_spec_join
           (correlated > 0.98)
  serve_sdp train_sdp's model: warmup(), 4 requests at noise_scale_w 0.8
           (the probe's frames are the decode's, the bucket the smallest
           that holds them), a seeded repeat (bit-equal), noise_scale_w 0
           against 0.8 (other frames), a noise-free batch of 16 held to
           single requests
  serve_bf16 the flagship in f32 and in bf16 (compute_dtype), the same
           weights: 8 noise-free requests (frames of each, correlation over
           the common length, RTF), each dtype's decoder on the same
           latents, a profiled request and a batch of 16 in each
  serve_mesh SynthesisModule(mesh=[cuda:0, cuda:0]) against the single
           device module: synthesize_batch of 16 seeded lines,
           decode_chunks_batched and batched decode_spec_join of one latent,
           each within atol 5e-4 (JAX's mesh bar); ms of each
The serving phases run last, as the serving module pins cuDNN's
deterministic algorithms for the process. Every serving call of their
modules runs as a CUDA graph, captured at its first input signature.
Every phase's line carries its wall seconds. Then one {"kernels": [...]}
line (launch counts from the forward, train, train_sdp, train_ms, eval_ms,
train_graphs, train_cli, train_data, ddp, tp and overfit run, a graph
replay counting the launches of its capture, the spawned ranks' own counts
added, and serving,
times, bounds; `launches_by_path` beside them: the main path's, those of
it in the ddp ranks' step-graph replays (`main.ddp_replays`) and the tp
ranks' (`main.tp_replays`), and
each measurement tool's of the bench phase, not added to `launches`;
`launches` counts the first
kernel of a port and `launches_by_kernel` each of its kernels: mas_bwd is
mas_bwd_kernel and mas_path_kernel), the card's name and power limit as
nvidia-smi prints them, and last {"ok": true, "device": {...}}. Every
device_busy_share a line carries (the union of the profiled device
activity over the wall time, utils.timing.profile_call) must be <= 1.

Any failed phase raises: the script exits non-zero and prints no result
line. It needs no network, starts no process that outlives it, and
imports nothing of JAX or of mb_istft_vits_tpu.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "ljs_mb_istft_vits.json")
FILELIST = os.path.join(REPO, "filelists",
                        "ljs_audio_text_test_filelist.txt.cleaned")
MS_CONFIG = os.path.join(REPO, "configs", "uudb_ms_istft_vits_ms.json")
MS_FILELIST = os.path.join(REPO, "filelists",
                           "uudb_audio_sid_text_train_filelist.txt")
ISTFT_CONFIG = os.path.join(REPO, "configs", "ljs_istft_vits.json")
sys.path.insert(0, REPO)
from mb_istft_vits_torch.bench_mas import bounds_ms  # noqa: E402
from mb_istft_vits_torch.infer.graphs import WARMUP_ITERS  # noqa: E402
from mb_istft_vits_torch.utils.timing import (  # noqa: E402
    kernel_time_ms,
    nvidia_smi,
    profile_call,
    time_ms,
)
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
BATCH = 16  # the training forward's and the train phases' batch
SERVE_REQUESTS = 8  # new-text requests after warmup, micro-batch callers
SERVE_BATCH = 16  # lines in the serve phase's synthesize_batch
TRAIN_STEPS = 6  # timed train steps after the first
TRAIN_MS_STEPS = 5  # the same, of the multi-speaker model
TRAIN_SDP_STEPS = 5  # the same, of the flagship with the stochastic predictor
SDP_REQUESTS = 4  # serve_sdp's requests at noise_scale_w 0.8
GRAPH_REQUESTS = 10  # headline requests timed in each of graphs and eager
KNOBS = (0.667, 1.0, 0.8)  # noise_scale, length_scale, noise_scale_w
OTHER_KNOBS = (0.3, 1.2, 0.5)


_phase_start = [time.perf_counter()]


def _busy_shares(tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "device_busy_share" and v is not None:
                yield v
            else:
                yield from _busy_shares(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _busy_shares(v)


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with its wall seconds (from `run_phase`);
    raises if a busy share in it exceeds 1."""
    print(json.dumps({"phase": phase, **fields, "wall_seconds":
                      time.perf_counter() - _phase_start[0]}), flush=True)
    over = [v for v in _busy_shares(fields) if v > 1.0]
    if over:
        raise AssertionError(f"{phase}: device busy shares above 1: {over}")


def run_phase(fn, *args):
    _phase_start[0] = time.perf_counter()
    return fn(*args)


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
    chained = {f: mas.maximum_path(neg_cent, mask, True, force=f)
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


def phase_serve():
    """The serving slice at flagship width, seeded random weights: warmup,
    new-text requests, the long-text route, batches, the chunked decodes
    of one latent, the micro-batcher and the streaming engine."""
    import threading

    import numpy as np

    from mb_istft_vits_torch.infer.synthesis import (
        SynthesisModule,
        _next_bucket,
    )
    from mb_istft_vits_torch.serve import (
        IncrementalTTS,
        MicroBatcher,
        TTSRequest,
    )

    sm = SynthesisModule(CONFIG, seed=0, device="cuda")
    hop, sr = sm.hop_length, sm.sampling_rate
    checks = {}

    def check(name, ok):
        checks[name] = checks.get(name, True) and bool(ok)

    warm_pairs = [(tb, _next_bucket(int(tb * sm._frames_per_token),
                                    sm.FRAME_BUCKETS))
                  for tb in sm.TEXT_BUCKETS]
    warm_frames = {fb for _, fb in warm_pairs}
    t0 = time.perf_counter()
    sm.warmup()
    warmup_s = time.perf_counter() - t0

    # new texts: token counts warmup did not run, each count once
    texts = _texts(80)
    fresh, seen = [], set(sm.TEXT_BUCKETS)
    for text in texts:
        k = len(sm.text_to_ids(text))
        if k not in seen and k <= sm.MAX_TEXT_TOKENS:
            fresh.append(text)
            seen.add(k)
    requests, repeats = [], []
    for i, text in enumerate(fresh[:SERVE_REQUESTS]):
        audio, tm = sm.synthesize(text, seed=i)
        pcm = audio * 32767.0
        check("requests_on_int16_grid", _wav_ok(audio)
              and audio.size % hop == 0
              and np.array_equal(pcm, np.round(pcm)))
        tokens = len(sm.text_to_ids(text))
        tb = _next_bucket(tokens, sm.TEXT_BUCKETS)
        requests.append({
            "tokens": tokens, "text_bucket": tb,
            "frame_bucket": tm["frame_bucket"],
            # the encoder's shapes follow the text bucket (all warmed),
            # the decoder's the frame bucket
            "frame_bucket_warmed": tm["frame_bucket"] in warm_frames,
            "audio_seconds": tm["audio_seconds"], "total": tm["total"],
            "rtf": tm["rtf"], "frontend": tm["frontend"],
            "dispatch": tm["dispatch"], "sync": tm["sync"]})
    for i, text in enumerate(fresh[:SERVE_REQUESTS]):
        _, tm = sm.synthesize(text, seed=i)  # every shape seen before
        repeats.append({"frame_bucket": tm["frame_bucket"],
                        "total": tm["total"], "rtf": tm["rtf"]})
    profile_new = profile_call(
        lambda: sm.synthesize(fresh[SERVE_REQUESTS], seed=0))

    # the long-text route: filelist lines joined past MAX_TEXT_TOKENS
    long_text = texts[0]
    for text in texts[1:]:
        if len(sm.text_to_ids(long_text)) > sm.MAX_TEXT_TOKENS:
            break
        long_text += " " + text
    audio, tm = sm.synthesize(long_text, seed=0)
    check("long_text_split", tm["pieces"] > 1 and _wav_ok(audio)
          and audio.size % hop == 0)
    long_route = {"tokens": len(sm.text_to_ids(long_text)),
                  "pieces": tm["pieces"], "frame_bucket": tm["frame_bucket"],
                  "audio_seconds": tm["audio_seconds"], "total": tm["total"],
                  "rtf": tm["rtf"]}

    # batches of 16 lines, at the model's rate and resampled to 16 kHz
    batch_texts = texts[:SERVE_BATCH]
    batches = {}
    for name, out_sr in (("first", None), ("repeat", None),
                         ("sr16000", 16000), ("sr16000_repeat", 16000)):
        audios, tm = sm.synthesize_batch(batch_texts, seed=0,
                                         out_sample_rate=out_sr)
        batches[name] = dict(tm, rows=len(audios))
        if out_sr is None:
            base = audios
            check("batch_rows", len(audios) == SERVE_BATCH and all(
                _wav_ok(a) and a.size % hop == 0 for a in audios))
        else:
            check("batch_16k_lengths", all(
                _wav_ok(a, -(-b.size * out_sr // sr))
                for a, b in zip(audios, base)))

    # one latent through every chunked decode, held to the whole decode
    z, y_len, _ = sm.prepare_shared_latents(fresh[0], seed=0)
    full = sm.infer_z_only(z)
    chunked = {}
    for rep in range(2):
        t0 = time.perf_counter()
        stream = sm.stream_from_latents(z)
        first = next(stream)
        ttfa = time.perf_counter() - t0
        joined = np.concatenate([first] + list(stream))
        chunked[f"stream_{rep}"] = (joined, {
            "first_chunk_s": ttfa, "total": time.perf_counter() - t0})
        for name, fn in (
                ("decode_chunks_batched", sm.decode_chunks_batched),
                ("decode_spec_join",
                 lambda z: sm.decode_spec_join(z)),
                ("decode_spec_join_batched",
                 lambda z: sm.decode_spec_join(z, batched=True))):
            t0 = time.perf_counter()
            out = fn(z)
            chunked[f"{name}_{rep}"] = (out, {
                "total": time.perf_counter() - t0})
    latent = {"frames": int(y_len), "full_samples": int(full.size)}
    for name, (out, tm) in chunked.items():
        corr = float(np.corrcoef(full, out)[0, 1]) if out.size == full.size \
            else None
        latent[name] = dict(tm, corr_with_full=corr)
        check("chunked_decodes", _wav_ok(out, y_len * hop)
              and corr is not None and corr > 0.98)

    # the micro-batcher: concurrent callers coalesce into batches
    mb_texts = fresh[:SERVE_REQUESTS]
    results, gate = {}, threading.Barrier(len(mb_texts))

    def call(i):
        gate.wait()
        results[i] = mb.synthesize(mb_texts[i], seed=7)

    with MicroBatcher(sm, max_batch=SERVE_REQUESTS, max_wait_ms=50.0) as mb:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(mb_texts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        mb_s = time.perf_counter() - t0
    check("microbatch_all_answered", len(results) == len(mb_texts))
    sizes = sorted(t["batched"] for _, t in results.values())
    check("microbatch_coalesced", max(sizes) >= 2)
    group = max((t for _, t in results.values()), key=lambda t: t["batched"])
    ref, _ = sm.synthesize_batch(group["batch_order"], seed=7)
    check("microbatch_rows_equal_batch", all(
        np.array_equal(results[i][0],
                       ref[group["batch_order"].index(mb_texts[i])])
        for i in results if mb_texts[i] in group["batch_order"]
        and results[i][1]["batched"] == group["batched"]))

    # the streaming engine, no send pacing: one utterance, then the same
    # text again (its shapes seen)
    text = fresh[1]
    _, y_len, _ = sm.prepare_shared_latents(text, noise_scale=0.0)
    arrivals = {"first": [], "again": []}
    engine = IncrementalTTS(sm, on_chunk=lambda uid, p: arrivals[uid].append(
        (time.perf_counter(), len(p) // 2)), send_interval_ms=0,
        base64_encode=False)
    engine.start()
    incremental = {}
    for uid, got in arrivals.items():
        t0 = time.perf_counter()
        engine.submit(TTSRequest(text=text, utterance_id=uid,
                                 noise_scale=0.0))
        while (sum(n for _, n in got) < y_len * hop
               and time.perf_counter() < t0 + 60):
            time.sleep(0.001)
        check("incremental_tts_complete",
              sum(n for _, n in got) == y_len * hop)
        incremental[uid] = {
            "chunks": len(got), "samples": sum(n for _, n in got),
            "first_chunk_s": got[0][0] - t0 if got else None,
            "last_chunk_s": got[-1][0] - t0 if got else None}
    engine.stop()

    emit("serve", config=os.path.relpath(CONFIG, REPO), weights="random",
         warmup_seconds=warmup_s, warmup_pairs=warm_pairs,
         requests=requests,
         median_rtf_new_text=statistics.median(r["rtf"] for r in requests),
         repeat_requests=repeats,
         median_rtf_repeat=statistics.median(r["rtf"] for r in repeats),
         # the single-request path before buckets and warmup (exact
         # length, a duration probe each call), as this script measured it
         # on an H100 80GB HBM3 at 700 W: the numbers to compare against
         unbucketed_median_rtf={"new_shapes": 0.0225, "repeat": 0.0076},
         profile_new_text=profile_new, long_text=long_route,
         batch=batches, latent=latent,
         microbatch={"callers": len(mb_texts), "batched": sizes,
                     "seconds": mb_s},
         incremental=incremental, checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"serve checks failed: {failed}")


def _wav_ok(audio, n=None):
    import numpy as np

    return (audio.dtype == np.float32 and audio.size > 0
            and bool(np.isfinite(audio).all())
            and (n is None or audio.size == n))


def _corr(a, b):
    import numpy as np

    return float(np.corrcoef(a, b)[0, 1]) if a.size == b.size else None


def _request_row(sm, text, sid, tm):
    return {"sid": sid, "tokens": len(sm.text_to_ids(text)),
            "frame_bucket": tm["frame_bucket"],
            "audio_seconds": tm["audio_seconds"], "total": tm["total"],
            "rtf": tm["rtf"], "dispatch": tm["dispatch"], "sync": tm["sync"]}


def _fresh_bucket_state(sm):
    """Forget the adaptive frames-per-token ratio, so the next request
    takes its frame bucket from the duration probe."""
    sm._frames_per_token, sm._ratio_observed = 3.0, False


def phase_serve_ms():
    """Serving the Japanese multi-speaker multi-stream model
    (uudb_ms_istft_vits_ms.json) at full width, seeded random weights:
    warmup(); 4 MS_FILELIST rows as requests under speaker 0 and again
    under speaker 11 (two speakers give two waveforms), one profiled, a
    seeded request repeated at one bucket (bit-equal); synthesize_batch of
    16 rows of mixed speakers, twice (bit-equal rows); one latent of
    speaker 5 through stream_from_latents and decode_spec_join (each
    correlated > 0.98 with the whole decode); the micro-batcher with 8
    callers of 8 speakers (coalesced rows bit-equal to synthesize_batch of
    the same texts and speakers); voice conversion of a synthesized
    utterance, speaker 0 -> 5, through the CLI's main() in this process."""
    import threading

    import numpy as np

    from mb_istft_vits_torch import voice_conversion
    from mb_istft_vits_torch.data.dataset import load_wav
    from mb_istft_vits_torch.infer.synthesis import SynthesisModule
    from mb_istft_vits_torch.serve import MicroBatcher
    from mb_istft_vits_torch.utils.audio import write_wav

    sm = SynthesisModule(MS_CONFIG, seed=0, device="cuda")
    hop = sm.hop_length
    checks = {}

    def check(name, ok):
        checks[name] = checks.get(name, True) and bool(ok)

    t0 = time.perf_counter()
    sm.warmup()
    warmup_s = time.perf_counter() - t0

    rows = ms_rows()
    texts = [t for _, t in rows[::500][:4]]
    requests, audio = [], {}
    for sid in (0, 11):
        for i, text in enumerate(texts):
            audio[sid, i], tm = sm.synthesize(text, sid, seed=i)
            check("requests_finite", _wav_ok(audio[sid, i])
                  and audio[sid, i].size % hop == 0)
            requests.append(_request_row(sm, text, sid, tm))
    check("speakers_differ", all(
        not np.array_equal(audio[0, i], audio[11, i])
        for i in range(len(texts))))
    profile = profile_call(lambda: sm.synthesize(texts[2], 3, seed=0))
    repeat = []
    for _ in range(2):
        _fresh_bucket_state(sm)
        repeat.append(sm.synthesize(texts[0], 0, seed=0))
    check("seeded_repeat_bit_equal",
          repeat[0][1]["frame_bucket"] == repeat[1][1]["frame_bucket"]
          and np.array_equal(repeat[0][0], repeat[1][0]))

    batch_texts = [t for _, t in rows[::100][:SERVE_BATCH]]
    batch_sids = [i % 12 for i in range(SERVE_BATCH)]
    batches, outs = {}, []
    for name in ("first", "repeat"):
        got, tm = sm.synthesize_batch(batch_texts, batch_sids, seed=0)
        batches[name] = dict(tm, rows=len(got))
        outs.append(got)
        check("batch_rows", len(got) == SERVE_BATCH and all(
            _wav_ok(a) and a.size % hop == 0 for a in got))
    check("batch_repeat_bit_equal", all(
        np.array_equal(a, b) for a, b in zip(*outs)))

    z, y_len, _ = sm.prepare_shared_latents(texts[0], 5, seed=0)
    full = sm.infer_z_only(z, 5)
    latent = {"frames": int(y_len)}
    for name, fn in (
            ("stream_from_latents",
             lambda: np.concatenate(list(sm.stream_from_latents(z, 5)))),
            ("decode_spec_join", lambda: sm.decode_spec_join(z, 5))):
        t0 = time.perf_counter()
        out = fn()
        latent[name] = {"total": time.perf_counter() - t0,
                        "corr_with_full": _corr(full, out)}
        check("chunked_decodes", _wav_ok(out, y_len * hop)
              and (latent[name]["corr_with_full"] or 0) > 0.98)

    mb_calls = list(zip(batch_texts[:SERVE_REQUESTS], range(SERVE_REQUESTS)))
    results, gate = {}, threading.Barrier(len(mb_calls))

    def call(i):
        gate.wait()
        results[i] = mb.synthesize(mb_calls[i][0], mb_calls[i][1], seed=7)

    with MicroBatcher(sm, max_batch=SERVE_REQUESTS, max_wait_ms=50.0) as mb:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(mb_calls))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        mb_s = time.perf_counter() - t0
    check("microbatch_all_answered", len(results) == len(mb_calls))
    sizes = sorted(t["batched"] for _, t in results.values())
    check("microbatch_coalesced", max(sizes) >= 2)
    group = max((t for _, t in results.values()), key=lambda t: t["batched"])
    members = list(zip(group["batch_order"], group["batch_sids"]))
    ref, _ = sm.synthesize_batch(group["batch_order"], group["batch_sids"],
                                 seed=7)
    check("microbatch_rows_keep_their_speaker", all(
        np.array_equal(results[i][0], ref[members.index(mb_calls[i])])
        for i in results if results[i][1] is group))

    with tempfile.TemporaryDirectory() as root:
        src, dst = (os.path.join(root, n) for n in ("src.wav", "vc.wav"))
        write_wav(src, audio[0, 0], sm.sampling_rate)
        t0 = time.perf_counter()
        rc = voice_conversion.main(["-c", MS_CONFIG, "-i", src, "--sid-src",
                                    "0", "--sid-tgt", "5", "-o", dst])
        vc_s = time.perf_counter() - t0
        converted, sr = load_wav(dst)
        source, _ = load_wav(src)
    check("voice_conversion", rc == 0 and sr == sm.sampling_rate
          and np.isfinite(converted).all() and converted.size == source.size
          and not np.array_equal(converted, source))

    emit("serve_ms", config=os.path.relpath(MS_CONFIG, REPO),
         weights="random", warmup_seconds=warmup_s, requests=requests,
         median_rtf=statistics.median(r["rtf"] for r in requests),
         profile_request=profile, seeded_repeat_bucket=repeat[0][1][
             "frame_bucket"], batch=batches, batch_sids=batch_sids,
         latent=latent, microbatch={"callers": len(mb_calls),
                                    "batched": sizes, "seconds": mb_s},
         voice_conversion={"seconds": vc_s, "samples": int(converted.size)},
         checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"serve_ms checks failed: {failed}")


def phase_serve_istft():
    """Serving the single-band iSTFT model (ljs_istft_vits.json) at full
    width: warmup(), 4 requests of FILELIST lines, one profiled, and one
    latent through decode_spec_join (correlated > 0.98 with the whole
    decode)."""
    from mb_istft_vits_torch.infer.synthesis import SynthesisModule

    sm = SynthesisModule(ISTFT_CONFIG, seed=0, device="cuda")
    hop = sm.hop_length
    t0 = time.perf_counter()
    sm.warmup()
    warmup_s = time.perf_counter() - t0
    texts = _texts(4)
    requests, ok = [], True
    for i, text in enumerate(texts):
        audio, tm = sm.synthesize(text, seed=i)
        ok = ok and _wav_ok(audio) and audio.size % hop == 0
        requests.append(_request_row(sm, text, None, tm))
    profile = profile_call(lambda: sm.synthesize(texts[1], seed=9))
    z, y_len, _ = sm.prepare_shared_latents(texts[0], seed=0)
    full = sm.infer_z_only(z)
    t0 = time.perf_counter()
    joined = sm.decode_spec_join(z)
    join_s = time.perf_counter() - t0
    corr = _corr(full, joined)
    checks = {"requests_finite": ok,
              "decode_spec_join": _wav_ok(joined, y_len * hop)
              and (corr or 0) > 0.98}
    emit("serve_istft", config=os.path.relpath(ISTFT_CONFIG, REPO),
         weights="random", warmup_seconds=warmup_s, requests=requests,
         median_rtf=statistics.median(r["rtf"] for r in requests),
         profile_request=profile,
         latent={"frames": int(y_len), "decode_spec_join_s": join_s,
                 "corr_with_full": corr}, checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"serve_istft checks failed: {failed}")


def phase_serve_sdp(root):
    """Serving the flagship with the stochastic duration predictor
    (train_sdp's config) at full width, seeded random weights: warmup();
    SDP_REQUESTS FILELIST lines at noise_scale_w 0.8, each with the frame
    bucket taken from the duration probe: the probe's frames are the
    decode's and its bucket the smallest that holds them; a profiled
    request (its bucket from the frames-per-token ratio); a seeded repeat
    (bit-equal); noise_scale_w 0 against 0.8 on one text and seed (other
    frames); synthesize_batch of SERVE_BATCH lines noise-free, each row
    held against the same line as a single request (equal length,
    correlated > 0.99)."""
    import numpy as np

    from mb_istft_vits_torch.infer.synthesis import SynthesisModule

    sm = SynthesisModule(sdp_config(root), seed=0, device="cuda")
    hop = sm.hop_length
    checks = {}

    def check(name, ok):
        checks[name] = checks.get(name, True) and bool(ok)

    t0 = time.perf_counter()
    sm.warmup()
    warmup_s = time.perf_counter() - t0

    # the module's probe and infer programs, observed from the host (the
    # model's own methods run only while a graph is captured)
    seen = {"probe": [], "decode": []}
    predict, infer = sm._predict_frames, sm._infer

    def probe(*args, **kwargs):
        out = predict(*args, **kwargs)
        seen["probe"].append([int(v) for v in out])
        return out

    def decode(*args, **kwargs):
        out = infer(*args, **kwargs)
        seen["decode"].append((args[6], [int(v) for v in out[1]]))
        return out

    sm._predict_frames, sm._infer = probe, decode
    try:
        texts = _texts(SDP_REQUESTS)
        requests = []
        for i, text in enumerate(texts):
            _fresh_bucket_state(sm)
            seen["probe"].clear()
            seen["decode"].clear()
            audio, tm = sm.synthesize(text, noise_scale_w=0.8, seed=i)
            frames = seen["probe"][0][0] if seen["probe"] else None
            check("requests_finite", _wav_ok(audio)
                  and audio.size % hop == 0)
            check("probe_frames_are_the_decodes", len(seen["probe"]) == 1
                  and all(y == [frames] for _, y in seen["decode"])
                  and audio.size == frames * hop)
            check("bucket_is_the_smallest_holding_them", seen["decode"]
                  and seen["decode"][0][0] == sm._frame_bucket_capped(frames))
            requests.append(dict(_request_row(sm, text, None, tm),
                                 probe_frames=frames,
                                 decodes=len(seen["decode"])))
    finally:
        del sm._predict_frames, sm._infer  # the class's methods again

    profile = profile_call(
        lambda: sm.synthesize(texts[1], noise_scale_w=0.8, seed=9))
    repeat = []
    for _ in range(2):
        _fresh_bucket_state(sm)
        repeat.append(sm.synthesize(texts[0], noise_scale_w=0.8, seed=0))
    check("seeded_repeat_bit_equal",
          repeat[0][1]["frame_bucket"] == repeat[1][1]["frame_bucket"]
          and np.array_equal(repeat[0][0], repeat[1][0]))
    _fresh_bucket_state(sm)
    still, _ = sm.synthesize(texts[0], noise_scale_w=0.0, seed=0)
    check("noise_scale_w_moves_the_frames", still.size != repeat[0][0].size)

    batch_texts = _texts(SERVE_BATCH)
    quiet = dict(noise_scale=0.0, noise_scale_w=0.0)
    t0 = time.perf_counter()
    rows, tm_batch = sm.synthesize_batch(batch_texts, **quiet)
    batch_s = time.perf_counter() - t0
    singles = []
    for text in batch_texts:
        _fresh_bucket_state(sm)
        singles.append(sm.synthesize(text, **quiet)[0])
    corrs = [_corr(a, b) for a, b in zip(rows, singles)]
    check("batch_rows_hold_to_single_requests", len(rows) == SERVE_BATCH
          and all(_wav_ok(a, b.size) for a, b in zip(rows, singles))
          and all(c is not None and c > 0.99 for c in corrs))

    emit("serve_sdp", config="configs/ljs_mb_istft_vits.json + use_sdp",
         weights="random", noise_scale_w=0.8, warmup_seconds=warmup_s,
         requests=requests,
         median_rtf=statistics.median(r["rtf"] for r in requests),
         profile_request=profile,
         seeded_repeat_bucket=repeat[0][1]["frame_bucket"],
         frames_noise_scale_w={"0.0": still.size // hop,
                               "0.8": repeat[0][0].size // hop},
         batch=dict(tm_batch, rows=len(rows), seconds=batch_s),
         batch_row_corr_min=min(c for c in corrs if c is not None)
         if any(c is not None for c in corrs) else None,
         checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"serve_sdp checks failed: {failed}")


def training_lengths(config, b, gen, texts=None):
    """Token ids [b, T_x] of the b longest of `texts` (default: the first
    500 lines of FILELIST; blanks interspersed), their lengths, and ragged
    frame counts in [400, 800] drawn from gen (at least the tokens; item 0
    has 800)."""
    import torch

    from mb_istft_vits_torch.text import frontend_ids

    d = config.data
    ids = sorted((frontend_ids(text, d.text_module, d.text_cleaners,
                               d.add_blank, d.cleaned_text)
                  for text in texts or _texts(500)), key=len)[-b:]
    x = torch.zeros((b, max(len(i) for i in ids)), dtype=torch.long)
    for i, seq in enumerate(ids):
        x[i, :len(seq)] = torch.tensor(seq)
    x_lengths = torch.tensor([len(s) for s in ids])
    y_lengths = torch.maximum(torch.randint(400, 801, (b,), generator=gen),
                              x_lengths)
    y_lengths[0] = 800
    return x, x_lengths, y_lengths


def phase_forward():
    """Flagship training forward, batch 16: returns the MAS inputs of the
    run for the kernels' main-path timing."""
    import torch

    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.models import Synthesizer
    from mb_istft_vits_torch.models.synthesizer import mas_neg_cent
    from mb_istft_vits_torch.ops import mas

    config = Config.from_json(CONFIG)
    cfg = config.model
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        model = Synthesizer(cfg)
    model = model.cuda().eval()  # eval: no dropout, so enc_p re-runs equal
    b = BATCH
    gen = torch.Generator().manual_seed(2)
    x, x_lengths, y_lengths = training_lengths(config, b, gen)
    t_x, t_y = x.shape[1], int(y_lengths.max())
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
    plain = mas.maximum_path(neg_cent, mask, use_pallas=False)
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


def train_batch(config, b, seed, texts=None):
    """A collate-shaped batch on the card, as `BucketedBatcher.make_batch`
    lays it out: the ids of the b longest of `texts` (training_lengths),
    and seeded int16 waveforms (a harmonic tone in noise) at the config's
    rate, of ragged length, T_y in [400, 800] frames plus a sub-hop tail,
    in a buffer of 800 * hop + (n_fft - hop) samples. The spectrogram is
    left to the trainer, on the card."""
    import numpy as np
    import torch

    d = config.data
    x, x_lengths, y_lengths = training_lengths(
        config, b, torch.Generator().manual_seed(seed), texts)
    rng = np.random.RandomState(seed)
    t_spec = int(y_lengths.max())
    t_wav = t_spec * d.hop_length + d.filter_length - d.hop_length
    samples = np.minimum(y_lengths.numpy() * d.hop_length
                         + rng.randint(0, d.hop_length, b), t_wav)
    wav = np.zeros((b, t_wav, 1), np.int16)
    for i, n in enumerate(samples):
        t = np.arange(n) / d.sampling_rate
        f0 = rng.uniform(90, 250)
        tone = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6)) / k
                   for k in range(1, 6))
        wav[i, :n, 0] = np.clip(3000 * tone + 800 * rng.randn(n), -32768,
                                32767)
    batch = {"x": x.int(), "x_lengths": x_lengths.int(),
             "spec_lengths": torch.from_numpy(np.minimum(
                 samples // d.hop_length, t_spec).astype(np.int32)),
             "wav": torch.from_numpy(wav),
             "wav_lengths": torch.from_numpy(samples.astype(np.int32))}
    return {k: v.cuda() for k, v in batch.items()}


def _dist_worker():
    """tests/torch_port_dist_worker.py: the data-parallel ranks, and the
    step helpers this script shares with them."""
    tests = os.path.join(REPO, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_port_dist_worker

    return torch_port_dist_worker


def run_train_steps(state, batch, timed_steps, after_first=None):
    """`train.step.train_step` on `batch`, which on the card runs the
    step's CUDA graph (train/graphs.py: eager warm-up steps, a capture,
    then replays): one first step (cuDNN picks its algorithms for every
    new shape; then `after_first(state)`), then `timed_steps` timed steps
    (host ms around a synced step, each marked eager, capture or replay;
    the last one the eager body, `train_step_eager`, split by CUDA events
    into prep + forward, D step and G step, and its MAS input and output
    recorded: a replay runs no Python to time or record), then one
    profiled step, a replay, with a trailing one cut from the profile.
    Returns the steps, `steady` (the replays' host ms), the split, peak
    memory, whether the recorded alignment equals the plain MAS, the
    profile with its MAS launches, and the graphs' counts."""
    from unittest import mock

    import torch

    from mb_istft_vits_torch import bench_train
    from mb_istft_vits_torch.models import synthesizer
    from mb_istft_vits_torch.ops import mas
    from mb_istft_vits_torch.train import step as tstep

    w = _dist_worker()

    def step(fn=tstep.train_step):
        n0 = w.mas_launches()
        before = w.graph_counts(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in fn(state, batch).items()}
        torch.cuda.synchronize()
        return {"host_ms": (time.perf_counter() - t0) * 1e3,
                "mas_launches": w.mas_launches() - n0, "metrics": metrics,
                "route": w.route(before, w.graph_counts(state))}

    torch.cuda.reset_peak_memory_stats()
    first = step()
    first_check = after_first(state) if after_first else None
    steps = [step() for _ in range(timed_steps - 1)]

    # the last timed step: CUDA events around its halves, MAS recorded
    mas_io = {}

    def recorded(fn):
        def run(neg_cent, mask, **kwargs):
            path = fn(neg_cent, mask, **kwargs)
            mas_io.update(neg_cent=neg_cent, mask=mask, path=path)
            return path
        return run

    begin = torch.cuda.Event(enable_timing=True)
    with bench_train.marked_halves() as marks, \
            mock.patch.object(synthesizer, "maximum_path",
                              recorded(synthesizer.maximum_path)):
        begin.record()
        steps.append(step(tstep.train_step_eager))
    split = bench_train.halves_ms(begin, marks)
    split["prep_and_forward_ms"] = split.pop("forward_ms")
    peak = torch.cuda.max_memory_allocated()
    plain = mas.maximum_path(mas_io["neg_cent"], mas_io["mask"], False)

    profile = w.profiled(state, batch)
    steady = [s["host_ms"] for s in steps if s["route"] == "replay"]
    return {"first": first, "steps": steps, "first_check": first_check,
            "split": split, "peak": peak, "steady": steady,
            "mas_shape": list(mas_io["neg_cent"].shape),
            "attn_equals_plain": torch.equal(mas_io["path"], plain),
            "profile": profile, "profiled_mas": profile["mas_launches"],
            "graphs": w.graph_report(state)}


def train_report(run, batch, config):
    """The JSON fields both training phases report."""
    profile = run["profile"]
    return dict(
        t_x_max=int(batch["x"].shape[1]),
        t_y_max=int(batch["spec_lengths"].max()),
        segment_size=config.train.segment_size, mas_shape=run["mas_shape"],
        first_step_ms=run["first"]["host_ms"], step_ms=run["steady"],
        step_ms_median=statistics.median(run["steady"]),
        split_last_step=run["split"], peak_memory_bytes=run["peak"],
        steps=[run["first"]] + run["steps"], graphs=run["graphs"],
        profile=profile, device_busy_share=profile["device_busy_share"],
        device_overlap_ms=profile["device_overlap_ms"],
        mas_device_share=(profile["mas_device_ms"] / profile["device_ms"]
                          if profile["device_ms"] else None))


def train_checks(run):
    """The checks both training phases hold."""
    steps = [run["first"]] + run["steps"]
    return {
        "metrics_finite": all(math.isfinite(v) for s in steps
                              for v in s["metrics"].values()),
        "mas_once_per_step": all(s["mas_launches"] == 1 for s in steps)
        and run["profiled_mas"] == 1,
        "profiled_mas_kernels_seen": run["profile"]["mas_kernels_seen"],
        "attn_equals_plain": run["attn_equals_plain"],
    }


def phase_train():
    """Flagship GAN training, batch 16, through `train.step.train_step`
    (run_train_steps: a first step, TRAIN_STEPS timed steps, a profiled
    one), then one step with fp16_run (bf16 autocast)."""
    import dataclasses

    import torch

    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.train import step as tstep

    config = Config.from_json(CONFIG)
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, batch_size=BATCH))
    state = tstep.create_train_state(config, torch.device("cuda"), seed=3)
    batch = train_batch(config, BATCH, seed=4)
    before = {f"{net}.{k}": v.detach().clone() for net, model in
              (("g", state.net_g), ("d", state.net_d))
              for k, v in model.named_parameters()}
    run = run_train_steps(state, batch, TRAIN_STEPS)
    bf16 = dataclasses.replace(state, cfg=dataclasses.replace(
        config, train=dataclasses.replace(config.train, fp16_run=True)))
    bf16_metrics = {k: float(v) for k, v in
                    tstep.train_step(bf16, batch).items()}

    params = {f"{net}.{k}": v for net, model in
              (("g", state.net_g), ("d", state.net_d))
              for k, v in model.named_parameters()}
    mel = [s["metrics"]["loss/g/mel"] for s in [run["first"]] + run["steps"]]
    checks = dict(train_checks(run), **{
        "params_changed": all(not torch.equal(v, before[k])
                              for k, v in params.items()),
        "master_params_f32": all(v.dtype == torch.float32
                                 for v in params.values()),
        "mel_loss_fell": mel[-1] < mel[0],
        "fp16_run_finite": all(math.isfinite(v)
                               for v in bf16_metrics.values()),
    })
    emit("train", batch=BATCH, **train_report(run, batch, config),
         loss_g_mel=mel, metrics_fp16_run=bf16_metrics, checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"train checks failed: {failed}")
    return statistics.median(run["steady"]), run["profile"]["device_ms"]


def sdp_config(root):
    """The flagship config with `model.use_sdp` true (upstream VITS's
    `configs/ljs_base.json` setting), written under root; its path."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["model"]["use_sdp"] = True
    path = os.path.join(root, "ljs_mb_istft_vits_sdp.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def phase_train_sdp(flagship, root):
    """The flagship with the stochastic duration predictor, on the train
    phase's batch and seeds: a first step, TRAIN_SDP_STEPS timed steps, a
    profiled one (run_train_steps), then one with fp16_run. Checks the
    training checks, a finite loss/g/dur (the predictor's flow NLL) and
    that every dp.* weight moved; its median step and profiled device
    time over the flagship's (the train phase's, in this run)."""
    import dataclasses

    import torch

    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.models.duration import (
        StochasticDurationPredictor,
    )
    from mb_istft_vits_torch.train import step as tstep

    step_ms, device_ms = flagship
    config = Config.from_json(sdp_config(root))
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, batch_size=BATCH))
    state = tstep.create_train_state(config, torch.device("cuda"), seed=3)
    batch = train_batch(config, BATCH, seed=4)
    before = {k: v.detach().clone()
              for k, v in state.net_g.dp.named_parameters()}
    run = run_train_steps(state, batch, TRAIN_SDP_STEPS)
    bf16 = dataclasses.replace(state, cfg=dataclasses.replace(
        config, train=dataclasses.replace(config.train, fp16_run=True)))
    bf16_metrics = {k: float(v) for k, v in
                    tstep.train_step(bf16, batch).items()}
    after = dict(state.net_g.dp.named_parameters())
    still = sorted(k for k, v in before.items() if torch.equal(v, after[k]))
    steps = [run["first"]] + run["steps"]
    checks = dict(train_checks(run), **{
        "stochastic_predictor": isinstance(state.net_g.dp,
                                           StochasticDurationPredictor),
        "loss_g_dur_finite": all(math.isfinite(s["metrics"]["loss/g/dur"])
                                 for s in steps),
        "every_dp_leaf_moved": len(before) > 100 and not still,
        "fp16_run_finite": all(math.isfinite(v)
                               for v in bf16_metrics.values()),
    })
    sdp_device_ms = run["profile"]["device_ms"]
    emit("train_sdp", config="configs/ljs_mb_istft_vits.json + use_sdp",
         batch=BATCH, **train_report(run, batch, config),
         loss_g_dur=[s["metrics"]["loss/g/dur"] for s in steps],
         dp_leaves=len(before), dp_leaves_unmoved=still,
         metrics_fp16_run=bf16_metrics,
         step_ms_over_flagship=statistics.median(run["steady"]) / step_ms,
         device_ms_over_flagship=(sdp_device_ms / device_ms
                                  if device_ms else None),
         checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"train_sdp checks failed: {failed}")


def ms_rows():
    """(sid, text) of MS_FILELIST's rows."""
    with open(MS_FILELIST, encoding="utf-8") as f:
        return [(int(sid), text) for _, sid, text in
                (line.rstrip("\n").split("|") for line in f)]


def ms_batch(config):
    """(rows, batch) of the 12-speaker model: the BATCH longest
    MS_FILELIST rows with their speakers, seeded int16 audio."""
    import torch

    from mb_istft_vits_torch.text import frontend_ids

    d = config.data
    rows = sorted(ms_rows(), key=lambda r: len(frontend_ids(
        r[1], d.text_module, d.text_cleaners, d.add_blank,
        d.cleaned_text)))[-BATCH:]
    # training_lengths keeps the b longest in this (ascending) order
    batch = train_batch(config, BATCH, seed=5, texts=[t for _, t in rows])
    batch["sid"] = torch.tensor([s for s, _ in rows], dtype=torch.int32,
                                device="cuda")
    return rows, batch


def phase_train_ms(flagship_step_ms):
    """The Japanese multi-speaker multi-stream model
    (uudb_ms_istft_vits_ms.json) at full width: batch 16 of the 16 longest
    MS_FILELIST rows with their speakers, seeded int16 audio at 16 kHz;
    a first step, TRAIN_MS_STEPS timed steps, a profiled one. Checks the
    training checks, loss/g/subband == 0 (the MS head has none), and that
    the first step's gradient of emb_g is non-zero exactly on the batch's
    speakers' rows. Its median step is also given over the flagship's
    (the train phase's, in this run)."""
    import dataclasses

    import torch

    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.train import step as tstep

    config = Config.from_json(MS_CONFIG)
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, batch_size=BATCH))
    rows, batch = ms_batch(config)
    state = tstep.create_train_state(config, torch.device("cuda"), seed=6)

    def speakers_with_gradient(state):
        grad = state.net_g.emb_g.weight.grad
        return sorted(int(i) for i in torch.nonzero(grad.abs().sum(dim=1)))

    run = run_train_steps(state, batch, TRAIN_MS_STEPS,
                          after_first=speakers_with_gradient)
    speakers = sorted({s for s, _ in rows})
    checks = dict(train_checks(run), **{
        "six_or_more_speakers": len(speakers) >= 6,
        "loss_g_subband_zero": all(
            s["metrics"]["loss/g/subband"] == 0.0
            for s in [run["first"]] + run["steps"]),
        "emb_g_grad_on_batch_speakers": run["first_check"] == speakers,
    })
    emit("train_ms", config=os.path.relpath(MS_CONFIG, REPO), batch=BATCH,
         speakers=speakers, emb_g_rows_with_gradient=run["first_check"],
         **train_report(run, batch, config),
         step_ms_over_flagship=statistics.median(run["steady"])
         / flagship_step_ms, checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"train_ms checks failed: {failed}")
    return state.net_g


# the train_graphs phase: synced steps timed in each of graphs and eager
# (alternating), and queued ones timed with CUDA events
GRAPH_STEPS = 3
# its compared step: lr 10 and eps 10 (the whole-step bars' setting, so
# the updated weights hold the gradients) at step 2 of 2-step epochs with
# lr_decay 0.5, so the replayed update must read the decayed lr 5
GRAPH_CMP_TRAIN = {"learning_rate": 10.0, "eps": 10.0, "steps_per_epoch": 2,
                   "lr_decay": 0.5}
GRAPH_CMP_STEP = 2
GRAPH_CMP_LR = 5.0
GRAPH_CROP_FRAMES = 600  # the second bucket: the batch cut to 600 frames
# cuDNN's default algorithms (held to the bars) and its deterministic ones
# with torch's deterministic algorithms (held bit for bit: the gradients
# of gather and of the embeddings are scatter-adds, whose atomics add in
# any order otherwise), each for the capture and the eager step alike
GRAPH_COMPARE = ({"enabled": True}, {"enabled": True, "deterministic": True})
# under the default algorithms the replay's G updates may lie this many
# times as far from the eager step's as the eager step's repeat does
GRAPH_G_NOISE = 3.0
GRAPH_EAGER_REPEATS = 2  # eager repeats that measure that distance


def _within_bars(d):
    """A step's `distance` from the eager one within the whole-step bars:
    loss scalars relative, D leaves max-abs, each G leaf's update relative
    in L2, over at least 100 G leaves."""
    return (d["loss_rel"] <= STEP_LOSS_REL and d["d_max_abs"] <= STEP_D_ATOL
            and d["g_update_rel_l2"] <= STEP_G_REL
            and d["g_leaves_compared"] >= 100)


def _hold_replay(c):
    """A `replay_vs_eager` under cuDNN's default algorithms: the losses and
    D leaves within their bars, and the G updates as one vector within the
    G bar or GRAPH_G_NOISE times the farther eager repeat's distance, the
    larger (`g_update_rel_l2_all_limit`, written into `c`), over at least
    100 G leaves."""
    r = c["replay"]
    c["g_update_rel_l2_all_limit"] = max([STEP_G_REL] + [
        GRAPH_G_NOISE * rep["g_update_rel_l2_all"]
        for rep in c["eager_repeats"]])
    return {"losses_and_d": r["loss_rel"] <= STEP_LOSS_REL
            and r["d_max_abs"] <= STEP_D_ATOL,
            "g_updates": r["g_update_rel_l2_all"]
            <= c["g_update_rel_l2_all_limit"]
            and r["g_leaves_compared"] >= 100}


def phase_train_graphs(root):
    """The training step as CUDA graphs per batch signature
    (train/graphs.py), against the eager body, in one process, for the
    flagship at batch 16 in f32 and with fp16_run, the SDP model and the
    12-speaker model (the train phases' batches):
    - a replayed step against the eager body from the same weights, draws
      and dropout seed (the dist worker's `replay_vs_eager`, each setting
      on its own copy of the state): bit for bit under cuDNN's and
      torch's deterministic algorithms; under the default ones the losses
      and D leaves at the whole-step bars, and the G updates as one
      vector within the G bar or GRAPH_G_NOISE times the eager step's
      distance from its own repeats, the larger (single G leaves of the
      eager step miss the G bar against its repeats there); the compared
      step is past an epoch boundary, so its update reads the decayed lr
      from the lr tensor;
    - at the config's own lr, the graph's warm-up and capture (seconds,
      pool bytes), then step ms of graphs and eager (host-synced and CUDA
      events), launches a warm step, busy share and MAS launches a step
      (the dist worker's `timed_routes`);
    - for the flagship in f32, a second bucket (the batch cut to
      GRAPH_CROP_FRAMES frames) captured once in the same pool, both
      buckets replayed in turns with no new capture, a checkpoint
      resume that drops the graphs and captures again, and the state on
      the two-pass MAS kernels (`mas_force="two_pass"`: a new key), their
      launches counted from the replays."""
    import copy
    import dataclasses
    import shutil

    import torch

    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.ops import mas
    from mb_istft_vits_torch.train import checkpoint
    from mb_istft_vits_torch.train import step as tstep

    w = _dist_worker()

    def batch16(path):
        cfg = Config.from_json(path)
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=BATCH))

    flagship = batch16(CONFIG)
    ms_config = batch16(MS_CONFIG)
    flagship_batch = train_batch(flagship, BATCH, seed=4)
    variants = {
        "flagship": (flagship, flagship_batch),
        "flagship_fp16_run": (dataclasses.replace(
            flagship, train=dataclasses.replace(flagship.train,
                                                fp16_run=True)),
            flagship_batch),
        "sdp": (batch16(sdp_config(root)), flagship_batch),
        "12_speakers": (ms_config, ms_batch(ms_config)[1]),
    }
    report, checks = {}, {}
    for name, (config, batch) in variants.items():
        cmp_cfg = dataclasses.replace(config, train=dataclasses.replace(
            config.train, **GRAPH_CMP_TRAIN))
        base = tstep.create_train_state(cmp_cfg, torch.device("cuda"),
                                        seed=3)
        init = tuple({k: v.detach().clone() for k, v in
                      net.state_dict().items()}
                     for net in (base.net_g, base.net_d))
        compared = []
        for setting in GRAPH_COMPARE:
            t0 = time.perf_counter()
            gs = copy.deepcopy(base)
            compared.append(w.replay_vs_eager(
                gs, batch, init, cmp_cfg, setting,
                0 if setting.get("deterministic") else GRAPH_EAGER_REPEATS,
                step=GRAPH_CMP_STEP))
            compared[-1]["seconds"] = time.perf_counter() - t0
            del gs
            torch.cuda.empty_cache()
        # the same weights at the config's own lr and schedule
        state = base
        w.reset(state, init, config)
        tstep.write_lr(state)
        del base, init
        warm = []
        for _ in range(WARMUP_ITERS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tstep.train_step(state, batch)
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        timed = w.timed_routes(state, batch, GRAPH_STEPS, GRAPH_STEPS)
        timed["seconds"] = time.perf_counter() - t0
        row = {"compared": compared, "warmup_and_capture_ms": warm,
               "graphs": w.graph_report(state), **timed}
        row["graph_over_eager_events"] = (timed["graph"]["step_ms_events"]
                                          / timed["eager"]["step_ms_events"])
        default, deterministic = compared
        # under cuDNN's default algorithms (and torch's atomic
        # scatter-adds) single G leaves of the eager step miss the G bar
        # against the eager step itself (its repeats: up to 2.9e-3 on a
        # leaf in f32, 1.9e-3 in bf16): there the losses and D leaves are
        # held to their bars, and the G updates as one vector to the G bar
        # or GRAPH_G_NOISE times the farther repeat's distance, the larger
        # (bf16's repeats lie 1.5-1.8e-4 from eager, or bit-equal); every
        # leaf is held bit for bit under the deterministic algorithms
        held = _hold_replay(default)
        checks[f"{name}_losses_and_d_within_bars"] = held["losses_and_d"]
        checks[f"{name}_g_updates_within_bar_or_eager_noise"] = \
            held["g_updates"]
        checks[f"{name}_bit_equal_deterministic"] = (
            deterministic["replay"]["bit_equal"]
            and _within_bars(deterministic["replay"]))
        checks[f"{name}_decayed_lr_replayed"] = all(
            c["lr_in_replayed_update"] == GRAPH_CMP_LR for c in compared)
        checks[f"{name}_one_graph_launch_a_step"] = \
            timed["graph"]["launches"]["cuda_graph_launch_calls"] == 1
        checks[f"{name}_mas_once_a_step"] = all(
            n == 1 for r in ("graph", "eager")
            for n in timed[r]["mas_launches_per_step"]) and all(
            c["replay_mas_launches"] == 1 for c in compared)
        # the replay rule's counts against the kernels the card ran
        checks[f"{name}_replayed_mas_kernels_seen"] = \
            timed["graph"]["mas_kernels_seen"]
        checks[f"{name}_one_capture"] = state.graphs.captures == 1 and all(
            c["captures"] == 1 and c["replay_route"] == "replay"
            for c in compared)
        checks[f"{name}_metrics_finite"] = timed["metrics_finite"] and all(
            c["metrics_finite"] for c in compared)

        if name == "flagship":
            d = config.data
            t_wav = (GRAPH_CROP_FRAMES * d.hop_length + d.filter_length
                     - d.hop_length)
            crop = dict(batch, wav=batch["wav"][:, :t_wav].contiguous(),
                        spec_lengths=batch["spec_lengths"].clamp(
                            max=GRAPH_CROP_FRAMES),
                        wav_lengths=batch["wav_lengths"].clamp(max=t_wav))
            pool_one = state.graphs.pool_bytes()
            second = [tstep.train_step(state, crop)
                      for _ in range(WARMUP_ITERS + 1)]
            captures = state.graphs.captures
            turns = [tstep.train_step(state, b)
                     for b in (batch, crop, batch, crop)]
            row["second_bucket"] = {
                "frames": GRAPH_CROP_FRAMES,
                "pool_bytes_one_graph": pool_one,
                "pool_bytes_two_graphs": state.graphs.pool_bytes(),
                "graphs": w.graph_report(state)}
            checks["two_buckets_two_captures"] = (
                captures == 2 == state.graphs.captures
                and len(state.graphs) == 2)
            checks["two_buckets_finite"] = all(
                math.isfinite(float(v)) for m in second + turns
                for v in m.values())
            model_dir = os.path.join(root, "train_graphs")
            checkpoint.save(model_dir, state)
            resumed = checkpoint.resume(model_dir, state)
            dropped = len(state.graphs) == 0
            again = [tstep.train_step(state, batch)
                     for _ in range(WARMUP_ITERS + 2)]
            row["resume"] = {"step": resumed, "graphs_dropped": dropped,
                             "graphs": w.graph_report(state)}
            checks["resume_recaptures"] = (
                dropped and state.graphs.captures == 3
                and all(math.isfinite(float(v)) for m in again
                        for v in m.values()))
            shutil.rmtree(model_dir, ignore_errors=True)
            # the two-pass MAS kernels (mas_fwd, mas_bwd) from a replay
            state.mas_force = "two_pass"
            n0 = dict(mas.launch_counts)
            two = [tstep.train_step(state, batch)
                   for _ in range(WARMUP_ITERS + 2)]
            launched = {k: mas.launch_counts[k] - n0[k] for k in n0}
            prof_two = w.profiled(state, batch)
            row["two_pass"] = {"steps": len(two), "launches": launched,
                               "profiled": prof_two["mas_counted"],
                               "profiled_kernels": prof_two["mas_kernels"],
                               "graphs": w.graph_report(state)}
            checks["two_pass_replayed"] = (
                state.graphs.captures == 4
                and launched == {"mas_fused": 0, "mas_fwd": len(two),
                                 "mas_bwd": len(two), "mas_path": len(two)}
                and all(math.isfinite(float(v)) for m in two
                        for v in m.values()))
            checks["two_pass_replayed_mas_kernels_seen"] = (
                prof_two["mas_kernels_seen"] and prof_two["mas_counted"]
                == {"mas_fwd": 1, "mas_bwd": 1, "mas_path": 1})
        report[name] = row
        del state
        torch.cuda.empty_cache()
    emit("train_graphs", batch=BATCH, warmup_iters=WARMUP_ITERS,
         compared_step={"train": GRAPH_CMP_TRAIN, "step": GRAPH_CMP_STEP,
                        "lr": GRAPH_CMP_LR},
         bars={"loss_rel": STEP_LOSS_REL, "d_max_abs": STEP_D_ATOL,
               "g_update_rel_l2": STEP_G_REL,
               "g_update_rel_l2_all_eager_noise": GRAPH_G_NOISE},
         variants=report, checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"train_graphs checks failed: {failed}")


EVAL_SCALARS = ("mcd_copy_synthesis", "lsd_copy_synthesis", "f0_rmse_hz",
                "voicing_decision_error", "mcd_tts_dtw", "dur_ratio_tts")


def sigterm_child(cfg, cwd):
    """The CLI in a child process on the card, to 500 steps: SIGTERM once
    its first metrics line is out. Returns (exit code, its output, the
    step it checkpointed at or None, seconds). The child is killed if it
    has not exited within 300 s, so it never outlives this script."""
    import signal

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mb_istft_vits_torch.train", "-c", cfg, "-m",
         "term", "--max-steps", "500"], cwd=cwd, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if re.search(r"\bstep \d+: \{", line):
                proc.send_signal(signal.SIGTERM)
                break
        lines.append(proc.communicate(timeout=300)[0])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines)
    m = re.search(r"SIGTERM: checkpointed at step (\d+), exiting", out)
    return (proc.returncode, out, int(m.group(1)) if m else None,
            time.perf_counter() - t0)


def phase_train_cli():
    """The training CLI on the card at the shrunk width, on the CLI tests'
    tiny dataset (tests/torch_port_data.py; 3 steps an epoch) with an
    eval and a pair every 2 steps and a metrics line every 3. In this
    process (its main(), so its MAS launches count): 10 steps, then a
    resumed run with --reset-optimizer to step 12. Checks the evals'
    scalars in the log, best.json naming a pair on disk, the pairs pruned
    to the newest 3 and the best, the metrics lines, the epoch snap and
    the fresh optimizers. Then a child run of the CLI: SIGTERM after its
    first metrics line leaves a complete pair and exit code 0."""
    import math

    import torch

    from mb_istft_vits_torch.train import checkpoint
    from mb_istft_vits_torch.train.__main__ import main as train_main

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_port_data import write_tiny_dataset

    with tempfile.TemporaryDirectory() as root:
        cfg = write_tiny_dataset(root, eval_interval=2, log_interval=3)
        cwd = os.getcwd()
        os.chdir(root)  # the CLI writes to ./logs/NAME
        try:
            t0 = time.perf_counter()
            args = ["-c", cfg, "-m", "smoke"]  # CUDA, the CLI's default
            rcs = [train_main(args + ["--max-steps", "10"])]
            t1 = time.perf_counter()
            rcs.append(train_main(args + ["--max-steps", "12",
                                          "--reset-optimizer"]))
            t2 = time.perf_counter()
        finally:
            os.chdir(cwd)
        model_dir = os.path.join(root, "logs", "smoke")
        with open(os.path.join(model_dir, "train.log")) as f:
            log = f.read()
        steps = {int(m.group(1)): json.loads(m.group(2)) for m in
                 re.finditer(r"step (\d+): (\{.*\})", log)}
        evals = [{k: float(v) for k, v in re.findall(r"(\w+)=(\S+)", line)}
                 for line in re.findall(r"eval: (\w+=.*)", log)]
        with open(os.path.join(model_dir, checkpoint.BEST)) as f:
            best = json.load(f)
        pairs = checkpoint.saved_steps(model_dir)
        g12 = torch.load(os.path.join(model_dir, "G_12.pth"),
                         map_location="cpu", weights_only=True)
        optim_steps = sorted({int(s["step"]) for s in
                              g12["optimizer"]["state"].values()})
        with open(cfg) as f:
            lr0 = json.load(f)["train"]["learning_rate"]
        rc_term, out_term, term_step, term_s = sigterm_child(cfg, root)
        term_pairs = checkpoint.saved_steps(os.path.join(root, "logs",
                                                         "term"))
    checks = {
        "exit_codes_zero": rcs == [0, 0],
        # the first run's 3, 6, 9 and the second's 12 (log_interval 3)
        "metrics_every_log_interval": sorted(steps) == [3, 6, 9, 12],
        "metrics_finite": all(math.isfinite(v) for m in steps.values()
                              for v in m.values()),
        # steps 2, 4, .., 10, then 10 and 12 again
        "eval_every_eval_interval": len(evals) == 7 and all(
            sorted(e) == sorted(EVAL_SCALARS)
            and all(math.isfinite(v) for v in e.values()) for e in evals),
        "best_names_a_pair_on_disk": best["step"] in pairs
        and float(f"{best['value']:.3f}") == min(
            e["mcd_copy_synthesis"] for e in evals),
        "pruned_to_newest_3_and_best":
            pairs == sorted({8, 10, 12, best["step"]}),
        "epoch_snap_logged": "resumed from step 10 (snapped to epoch "
                             "boundary 9) (optimizer reset)" in log,
        "reset_optimizer_fresh": optim_steps == [3]
        and abs(steps.get(12, {}).get("learning_rate", 0) - lr0)
        <= 1e-6 * lr0,
        # the child's newest pair is the SIGTERM's (its evals save too)
        "sigterm_exit_0_with_a_pair": rc_term == 0
        and term_step is not None and term_pairs[-1:] == [term_step],
    }
    emit("train_cli", seconds_first_run=t1 - t0, seconds_resumed_run=t2 - t1,
         steps_per_sec={s: m["steps_per_sec"] for s, m in steps.items()},
         evals=evals, best=best, pairs=pairs, optimizer_steps_at_12=optim_steps,
         sigterm={"exit_code": rc_term, "step": term_step, "pairs": term_pairs,
                  "seconds": term_s, "tail": out_term[-600:]},
         checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"train_cli checks failed: {failed}")


def phase_eval_ms(net_g):
    """`train.loop.evaluate` once, at full width, on train_ms's generator
    (uudb_ms_istft_vits_ms.json): a synthesis per speaker (12), the copy
    synthesis of validation item 0 and the metrics. Its validation set is
    seeded 16 kHz audio for the first MS_FILELIST row of each of 6
    speakers (tests/torch_port_data.py). Reports the seconds and the
    scalars: what one eval costs a user of that config."""
    import logging
    from unittest import mock

    import numpy as np

    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.data import TextAudioDataset
    from mb_istft_vits_torch.train.loop import evaluate

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_port_data import write_tiny_dataset

    config = Config.from_json(MS_CONFIG)
    logger = logging.getLogger("chip_smoke.eval_ms")
    logger.propagate = False
    with tempfile.TemporaryDirectory() as root:
        tiny = Config.from_json(write_tiny_dataset(root, multi_speaker=True))
        ds = TextAudioDataset(tiny.data.validation_files, config.data,
                              seed=config.train.seed, device_spec=True)
        infer = net_g.infer
        with mock.patch.object(net_g, "infer",
                               side_effect=infer) as syntheses:
            t0 = time.perf_counter()
            evaluate(config, net_g, 0, logger, ds)  # first: every shape new
            first_seconds = time.perf_counter() - t0
            syntheses.reset_mock()
            t0 = time.perf_counter()
            scalars = evaluate(config, net_g, 1, logger, ds)
            seconds = time.perf_counter() - t0
        item_seconds = (np.asarray(ds[0]["wav"]).size
                        / config.data.sampling_rate)
    checks = {
        "one_synthesis_per_speaker": syntheses.call_count == 12,
        "scalars": sorted(k.split("/")[-1] for k in scalars or {})
        == sorted(EVAL_SCALARS)
        and all(math.isfinite(v) for v in scalars.values()),
    }
    emit("eval_ms", config=os.path.relpath(MS_CONFIG, REPO),
         weights="train_ms's", speakers=config.data.n_speakers,
         item_seconds=item_seconds, first_seconds=first_seconds,
         seconds=seconds, scalars=scalars,
         checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"eval_ms checks failed: {failed}")


TRAIN_DATA_BUCKETS = (2, 3)  # (500, 600] and (600, 700] frames: 2 batches each
LJS_FILELISTS = [os.path.join(REPO, "filelists", name) for name in (
    "ljs_audio_text_test_filelist.txt.cleaned",
    "ljs_audio_text_val_filelist.txt.cleaned",
    "ljs_audio_text_train_filelist.txt.cleaned")]


def write_train_corpus(root, config, per_bucket):
    """The train_data corpus: LJSpeech cleaned lines rendered by the port's
    synthetic renderer (utils/corpus.py) to int16 wavs at the config's
    rate, per_bucket rows in each of the default buckets (500, 600] and
    (600, 700] spectrogram frames (the test lines first, then the val and
    train lines). Returns the filelist's path."""
    import collections

    import numpy as np
    from scipy.io import wavfile

    from mb_istft_vits_torch.data.dataset import BOUNDARIES
    from mb_istft_vits_torch.utils.audio import float_to_int16
    from mb_istft_vits_torch.utils.corpus import render, rendered_samples

    d = config.data
    os.makedirs(root, exist_ok=True)
    edges = [(BOUNDARIES[b + 1], BOUNDARIES[b + 2])
             for b in TRAIN_DATA_BUCKETS]
    kept, rows = collections.Counter(), []
    for filelist in LJS_FILELISTS:
        with open(filelist, encoding="utf-8") as f:
            for line in f:
                path, text = line.rstrip("\n").split("|")[:2]
                if not d.min_text_len <= len(text) <= d.max_text_len:
                    continue
                name = os.path.basename(path)
                # the dataset's estimate from the wav's size, 44-byte
                # header included
                frames = (44 + 2 * rendered_samples(
                    text, name, sr=d.sampling_rate)) // (2 * d.hop_length)
                bucket = next((i for i, (lo, hi) in enumerate(edges)
                               if lo < frames <= hi), None)
                if bucket is None or kept[bucket] >= per_bucket:
                    continue
                wav = os.path.join(root, name)
                wavfile.write(wav, d.sampling_rate, float_to_int16(
                    render(text, name, sr=d.sampling_rate)))
                rows.append(f"{wav}|{text}")
                kept[bucket] += 1
                if min(kept[i] for i in range(len(edges))) >= per_bucket:
                    out = os.path.join(root, "train.txt")
                    with open(out, "w", encoding="utf-8") as f:
                        f.write("\n".join(rows) + "\n")
                    return out
    raise AssertionError(f"LJSpeech lines fill only {dict(kept)} rows")


def run_feed(state, batcher, epoch, feeder=None):
    """One epoch of `batcher` through the trainer's own iterator
    (`train.loop._batches`: loader threads and the side-stream copy, or
    the device-resident gather) and `train_step`: per step the ms spent
    waiting for the batch, the synced step's host ms, the MAS launches,
    the bytes that crossed host to device for the batch (the batch's own
    for a host feed; the index vector for the resident one) and the
    metrics."""
    import torch

    from mb_istft_vits_torch.train import loop
    from mb_istft_vits_torch.train import step as tstep

    w = _dist_worker()
    steps = []
    it = loop._batches(batcher, epoch, epoch + 1, torch.device("cuda"),
                       feeder)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n0 = w.mas_launches()
        before = w.graph_counts(state)
        metrics = {k: float(v) for k, v in
                   tstep.train_step(state, batch).items()}
        torch.cuda.synchronize()
        steps.append({
            "wait_ms": (t1 - t0) * 1e3,
            "host_ms": (time.perf_counter() - t1) * 1e3,
            "route": w.route(before, w.graph_counts(state)),
            "mas_launches": w.mas_launches() - n0,
            "h2d_bytes": (4 * len(batch["x"]) if feeder is not None
                          else sum(v.nbytes for v in batch.values())),
            "t_y": int(batch["spec_lengths"].max()),
            "metrics": metrics})
    return steps


def _first_nonfinite(feeds):
    """The first step (in feed order) with a non-finite metric: its feed,
    index there, its metrics and the step's before it; None if none."""
    prev = None
    for feed, steps in feeds.items():
        for i, s in enumerate(steps):
            if not all(math.isfinite(v) for v in s["metrics"].values()):
                return {"feed": feed, "step": i, "metrics": s["metrics"],
                        "previous": prev}
            prev = s["metrics"]
    return None


def phase_train_data(root):
    """The flagship at full width and the config's own batch (64) fed from
    disk: a corpus of LJSpeech lines rendered to wavs (write_train_corpus,
    2 buckets x 2 batches, one epoch = 4 steps), trained one epoch in each
    feed through the trainer's iterator: the default device-spec int16
    PCM, host spectrograms with their .spec.npy caches (the first epoch
    writes them; a second reads them), and the corpus held on the card.
    Checks the native loader path, a cache for every row, host
    spectrograms against the card's dsp.stft.spectrogram, resident batches
    equal to the host batcher's, the pool's bytes, one MAS launch a step;
    reports each feed's step ms, batch wait and host-to-device bytes, one
    profiled step and peak memory. Saves the pair for the tools phase.
    Returns (config path, model dir)."""
    import numpy as np
    import torch

    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.data import (
        BucketedBatcher,
        DeviceResidentFeeder,
        TextAudioDataset,
        dataset,
        native_audio,
    )
    from mb_istft_vits_torch.dsp.stft import spectrogram
    from mb_istft_vits_torch.train import checkpoint
    from mb_istft_vits_torch.train import step as tstep

    config = Config.from_json(CONFIG)
    d, batch_size = config.data, config.train.batch_size
    t0 = time.perf_counter()
    filelist = write_train_corpus(os.path.join(root, "train_data"), config,
                                  2 * batch_size)
    corpus_s = time.perf_counter() - t0
    cfg_path = os.path.join(root, "train_data", "config.json")
    with open(CONFIG) as f:
        cfg_json = json.load(f)
    cfg_json["data"].update(training_files=filelist, validation_files=filelist)
    with open(cfg_path, "w") as f:
        json.dump(cfg_json, f)

    dataset.loader_paths.clear()
    pcm = BucketedBatcher(TextAudioDataset(filelist, d, config.train.seed,
                                           device_spec=True), batch_size)
    host = BucketedBatcher(TextAudioDataset(filelist, d, config.train.seed),
                           batch_size)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    feeder = DeviceResidentFeeder(pcm, device="cuda")
    upload_s = time.perf_counter() - t0
    pool_allocated = torch.cuda.memory_allocated() - before
    state = tstep.create_train_state(config, torch.device("cuda"), seed=3)
    torch.cuda.reset_peak_memory_stats()
    # one step per bucket shape first: cuDNN plans and allocator growth
    # are paid here, not by the first feed
    warm = []
    for bi in range(len(pcm.buckets)):
        if not pcm.buckets[bi]:  # the first bucket stays, empty or not
            continue
        t0 = time.perf_counter()
        tstep.train_step(state, {k: torch.from_numpy(v).cuda() for k, v in
                                 pcm.make_batch(bi, pcm.buckets[bi][
                                     :batch_size]).items()})
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    feeds = {"pcm": run_feed(state, pcm, 0),
             "host_spec": run_feed(state, host, 0),
             "resident": run_feed(state, pcm, 0, feeder),
             "host_spec_cached": run_feed(state, host, 1)}
    peak = torch.cuda.max_memory_allocated()
    last = len(pcm.buckets) - 1
    probe = {k: torch.from_numpy(v).cuda() for k, v in
             pcm.make_batch(last, pcm.buckets[last][:batch_size]).items()}
    w = _dist_worker()
    before = w.graph_counts(state)
    profile = w.profiled(state, probe)
    profiled_mas = profile["mas_launches"]
    after = w.graph_counts(state)

    rows = [r[0] for r in host.dataset.rows]
    cached = [os.path.exists(os.path.splitext(p)[0] + ".spec.npy")
              for p in rows]
    spec_gaps = []
    for path in rows[:4]:
        host_spec = np.load(os.path.splitext(path)[0] + ".spec.npy")
        wav = host.dataset.get_audio(path)[1]
        card = spectrogram(torch.from_numpy(wav).cuda(), d.filter_length,
                           d.hop_length, d.win_length)[0].T.cpu().numpy()
        gap = float(np.abs(card - host_spec).max())
        spec_gaps.append({"frames": int(host_spec.shape[0]), "max_abs": gap,
                          "relative": gap / float(np.abs(host_spec).max())})
    resident_equal = all(
        sorted(g) == sorted(w) and all(
            torch.equal(g[k], torch.from_numpy(v).cuda())
            for k, v in w.items())
        for g, w in zip(feeder.iter_epoch(0), pcm.iter_epoch(0)))
    model_dir = os.path.join(root, "train_data", "logs")
    checkpoint.save(model_dir, state)

    paths = dict(dataset.loader_paths)
    all_steps = [s for steps in feeds.values() for s in steps]

    def summary(steps):
        ms = [s["host_ms"] for s in steps]
        replays = [s["host_ms"] for s in steps if s["route"] == "replay"]
        return {"step_ms": ms, "step_ms_median": statistics.median(ms),
                "route": [s["route"] for s in steps],
                "replay_ms_median": statistics.median(replays)
                if replays else None,
                "wait_ms": [s["wait_ms"] for s in steps],
                "h2d_bytes_per_step": statistics.median(
                    s["h2d_bytes"] for s in steps),
                "t_y": [s["t_y"] for s in steps]}

    checks = {
        "batch_is_the_configs_64": batch_size == 64,
        "one_epoch_is_4_steps": all(len(s) == 4 for s in feeds.values()),
        "native_loader_path": native_audio.available()
        and paths.get("wav_native", 0) > 0
        and paths.get("spec_native", 0) > 0
        and not paths.get("wav_scipy") and not paths.get("spec_numpy"),
        "every_row_has_its_spec_npy": len(rows) == 4 * batch_size
        and all(cached),
        "host_spec_matches_card_spectrogram": all(
            g["relative"] <= 1e-4 for g in spec_gaps),
        "resident_batches_equal_host_batches": resident_equal,
        "pool_bytes_equal_corpus_bytes":
            feeder.nbytes == DeviceResidentFeeder.corpus_bytes(pcm)
            and pool_allocated >= feeder.nbytes,
        "mas_once_per_step": all(s["mas_launches"] == 1 for s in all_steps)
        and profiled_mas == 1,
        "profiled_mas_kernels_seen": profile["mas_kernels_seen"],
        "metrics_finite": all(math.isfinite(v) for s in all_steps
                              for v in s["metrics"].values()),
        # the profiled step and its two trailing ones: replays, no capture
        "profiled_step_replayed": after == (before[0], before[1] + 3),
    }
    emit("train_data", config=os.path.relpath(CONFIG, REPO),
         batch=batch_size, rows=len(rows), corpus_seconds=corpus_s,
         buckets=pcm.boundaries, loader_paths=paths,
         pool_bytes=feeder.nbytes, pool_allocated_bytes=pool_allocated,
         corpus_bytes=DeviceResidentFeeder.corpus_bytes(pcm),
         upload_seconds=upload_s, warmup_step_ms=warm,
         feeds={k: summary(v) for k, v in feeds.items()},
         loss_g_mel=[s["metrics"]["loss/g/mel"] for s in all_steps],
         first_nonfinite=_first_nonfinite(feeds),
         host_spec_vs_card=spec_gaps, peak_memory_bytes=peak,
         graphs=w.graph_report(state),
         profile=profile, device_busy_share=profile["device_busy_share"],
         device_overlap_ms=profile["device_overlap_ms"], checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"train_data checks failed: {failed}")
    return cfg_path, model_dir


def _tool(*args, cwd, env=None):
    """A port CLI in a child process, `env` added to this one's; (Popen,
    its output file)."""
    env = {**os.environ, **(env or {})}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, "-m",
                             f"mb_istft_vits_torch.{args[0]}", *args[1:]],
                            cwd=cwd, env=env, stdout=out,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out


def _finish(proc, out, timeout=300):
    """(exit code, output) of a _tool child; killed past the timeout."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    out.seek(0)
    text = out.read()
    out.close()
    return proc.returncode, text


def phase_tools(root, trained):
    """The offline tools as a user runs them, each a child process on the
    card: eval_checkpoint on train_data's pair (-n 4 --tts --save-audio
    --out), eval_metrics on its ground truth against its copy synthesis,
    make_corpus of a UUDB corpus (utils/corpus.py) then eval_vc of the
    12-speaker config with random weights on 2 pairs, and preprocess of
    Japanese katakana rows; eval_checkpoint, the corpus and preprocess run
    side by side. Checks each exit code 0 and finite scores."""
    import numpy as np
    import torch

    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.models import Synthesizer
    from mb_istft_vits_torch.train import checkpoint

    cfg_path, model_dir = trained
    work = os.path.join(root, "tools")
    os.makedirs(work)
    pth = os.path.join(model_dir,
                       f"G_{checkpoint.latest_step(model_dir)}.pth")
    jp_list = os.path.join(work, "jp.txt")
    with open(jp_list, "w", encoding="utf-8") as f:
        f.write("a.wav|0|コンニチハ\nb.wav|5|アリガトウゴザイマシタ\n")
    t0 = time.perf_counter()
    running, results = {}, {}
    try:
        running["eval_checkpoint"] = _tool(
            "eval_checkpoint", "-c", cfg_path, "-k", pth, "-n", "4", "--tts",
            "--save-audio", "wavs", "--out", "eval.json", cwd=work)
        running["make_corpus"] = _tool(
            "make_corpus", "uudb", "--dataset", "uudb", "--n-train", "1",
            "--n-val", "24", cwd=work)
        running["preprocess"] = _tool(
            "preprocess", "--filelists", jp_list, "--text_index", "2",
            "--text_module", "text_JP", "--text_cleaners",
            "japanese_cleaners", cwd=work)
        # each tool starts once its input is there
        results["make_corpus"] = _finish(*running.pop("make_corpus"))
        if results["make_corpus"][0] == 0:
            # the 12-speaker config at full width, random weights
            ms_cfg = Config.from_json(os.path.join(work, "uudb",
                                                   "config.json"))
            torch.manual_seed(0)
            torch.save({"model": Synthesizer(ms_cfg.model).state_dict()},
                       os.path.join(work, "G_ms.pth"))
            running["eval_vc"] = _tool(
                "eval_vc", "-c", "uudb/config.json", "-k", "G_ms.pth",
                "--pairs", "0:5", "3:7", cwd=work)
        results["eval_checkpoint"] = _finish(*running.pop("eval_checkpoint"))
        running["eval_metrics"] = _tool(
            "eval_metrics", "wavs/utt0_gt.wav", "wavs/utt0_copy.wav",
            "--json", "metrics.json", cwd=work)
        for name in list(running):
            results[name] = _finish(*running.pop(name))
    finally:  # no child outlives a failure here
        for proc, out in running.values():
            _finish(proc, out, timeout=0)
    results.setdefault("eval_vc", (None, ""))
    seconds = time.perf_counter() - t0
    rcs = {name: rc for name, (rc, _) in results.items()}
    report = {}
    if rcs["eval_checkpoint"] == 0:
        with open(os.path.join(work, "eval.json")) as f:
            report["eval_checkpoint"] = json.load(f)["summary"]
    if rcs["eval_metrics"] == 0:
        with open(os.path.join(work, "metrics.json")) as f:
            report["eval_metrics"] = json.load(f)[0]
    vc_rows = [line for line in results["eval_vc"][1].splitlines()
               if re.match(r"\s*\d+->\d+\s+\|", line)]
    cleaned = None
    if os.path.exists(jp_list + ".cleaned"):
        with open(jp_list + ".cleaned", encoding="utf-8") as f:
            cleaned = f.read().splitlines()

    def finite(tree):
        if isinstance(tree, dict):
            return all(finite(v) for v in tree.values())
        return not isinstance(tree, float) or math.isfinite(tree)

    checks = {
        "exit_codes_zero": all(rc == 0 for rc in rcs.values()),
        "eval_checkpoint_finite": "eval_checkpoint" in report
        and report["eval_checkpoint"]["n_utts"] == 4
        and finite(report["eval_checkpoint"]),
        "eval_metrics_finite": "eval_metrics" in report
        and finite(report["eval_metrics"]),
        "eval_vc_two_pairs_finite": len(vc_rows) == 2
        and "nan" not in " ".join(vc_rows),
        "preprocess_rows": cleaned is not None and len(cleaned) == 2,
    }
    emit("tools", seconds=seconds, exit_codes=rcs, scores=report,
         eval_vc_rows=vc_rows, preprocess_rows=cleaned,
         tails={k: v[-400:] for k, (rc, v) in results.items() if rc != 0},
         checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"tools checks failed: {failed}")


def phase_serve_bf16():
    """The flagship served with the same seeded weights in f32 and in
    bf16 (compute_dtype; the iSTFT and after in f32): after warmup(), 8
    noise-free filelist lines in each, per request the frames of each,
    the correlation over the common length and the RTF; the decoder of
    each on the f32 module's latents of the request (equal frames by
    construction); one profiled request in each dtype; a batch of 16 in
    each. Checks the PCM on the int16 grid, the decoders' correlation
    >= 0.99 on every request and the requests' correlation >= 0.99
    wherever the frames are equal; frames that differ are counted."""
    import numpy as np
    import torch

    from mb_istft_vits_torch.infer.synthesis import SynthesisModule

    mods = {"f32": SynthesisModule(CONFIG, None, None, 0, device="cuda"),
            "bf16": SynthesisModule(CONFIG, None, None, 0, torch.bfloat16,
                                    device="cuda")}
    warm = {}
    for name, sm in mods.items():
        t0 = time.perf_counter()
        sm.warmup()
        warm[name] = time.perf_counter() - t0
    quiet = dict(noise_scale=0.0, seed=0)
    requests, checks = [], {}

    def check(name, ok):
        checks[name] = checks.get(name, True) and bool(ok)

    for text in _texts(SERVE_REQUESTS):
        out = {}
        for name, sm in mods.items():
            _fresh_bucket_state(sm)
            out[name] = sm.synthesize(text, **quiet)
        (a, ta), (b, tb) = out["bf16"], out["f32"]
        pcm = a * 32767.0
        check("bf16_on_int16_grid", _wav_ok(a)
              and np.array_equal(pcm, np.round(pcm)))
        n = min(a.size, b.size)
        corr = _corr(a[:n], b[:n])
        z, _, _ = mods["f32"].prepare_shared_latents(text, **quiet)
        dec = _corr(mods["bf16"].infer_z_only(z), mods["f32"].infer_z_only(z))
        check("decoder_corr_at_least_0.99", dec >= 0.99)
        if a.size == b.size:
            check("corr_at_least_0.99_at_equal_frames", corr >= 0.99)
        requests.append({
            "frames": {"bf16": a.size // 256, "f32": b.size // 256},
            "frame_bucket": {"bf16": ta["frame_bucket"],
                             "f32": tb["frame_bucket"]},
            "corr_common_length": corr, "decoder_corr": dec,
            "rtf": {"bf16": ta["rtf"], "f32": tb["rtf"]}})
    profiles = {name: profile_call(lambda sm=sm: sm.synthesize(
        _texts(SERVE_REQUESTS + 1)[-1], **quiet)) for name, sm in mods.items()}
    batches = {}
    for name, sm in mods.items():
        sm.synthesize_batch(_texts(SERVE_BATCH), **quiet)  # shapes seen
        rows, tm = sm.synthesize_batch(_texts(SERVE_BATCH), **quiet)
        batches[name] = dict(tm, rows=rows)
        check(f"batch_rows_{name}", len(rows) == SERVE_BATCH
              and all(_wav_ok(r) for r in rows))
    emit("serve_bf16", config=os.path.relpath(CONFIG, REPO),
         weights="random (seed 0), equal in both dtypes",
         warmup_seconds=warm, requests=requests,
         frames_differ=sum(r["frames"]["bf16"] != r["frames"]["f32"]
                           for r in requests),
         median_rtf={k: statistics.median(r["rtf"][k] for r in requests)
                     for k in mods},
         profile_request=profiles,
         batch={k: {m: v for m, v in b.items() if m != "rows"}
                for k, b in batches.items()},
         batch_row_corr=[_corr(x, y) for x, y in zip(
             batches["bf16"]["rows"], batches["f32"]["rows"])
             if x.size == y.size],
         checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"serve_bf16 checks failed: {failed}")


DDP_ROWS = 8  # rows a rank: two ranks make the train phase's batch of 16
# timed steps after the compared ones: the warm-ups, the capture, a replay
DDP_STEPS = 4
DDP_SEED = 3  # the weights (the worker's seeded_state)
DDP_ROUTE_STEPS = 2  # queued steps timed in each of the stage graphs and eager
DDP_KERNEL_LAUNCHES = 20  # a warm replayed rank step launches fewer kernels
# whole-step bars of the CPU parity tests (tests/test_torch_port_ddp.py):
# lr 10 and eps 10 make the first AdamW update a smooth function of the
# gradient, so the updated weights hold the gradients
STEP_LOSS_REL, STEP_D_ATOL, STEP_G_REL = 1e-4, 1e-4, 2e-4
# the cuDNN settings of the ddp phase's compared steps. With cuDNN off
# (torch's own convolutions, which compute each row of a batch alone) the
# step is held to the single-process step on all 16 rows. With cuDNN's
# deterministic algorithms it is held to a single-process step that sums
# the gradients of the two 8-row halves (`_accumulated_step`): cuDNN picks
# its algorithms by batch size, so against the 16-row step, which it
# computes with others, the decoder's resblock leaves differ by ~5e-4
# (PERF.md); that reading is reported beside it
DDP_COMPARE = ({"enabled": False}, {"enabled": True, "deterministic": True})
# launches of the MAS kernels in the ranks this script spawns (each child
# counts its own), added to the main path's counts
CHILD_LAUNCHES = {}
# those of them in the ranks' replays of the step graphs, by path: the
# data-parallel ranks' (ddp) and the 2-D ranks' (tp)
REPLAYED_LAUNCHES = {"main.ddp_replays": {}, "main.tp_replays": {}}


def _add_child_launches(ranks, replays=None):
    for r in ranks:
        for k, v in r.get("launch_counts", {}).items():
            CHILD_LAUNCHES[k] = CHILD_LAUNCHES.get(k, 0) + v
        for k, v in r.get("replayed_launches", {}).items():
            path = REPLAYED_LAUNCHES[replays]
            path[k] = path.get(k, 0) + v


def _compare_step(metrics, g, d, ref_metrics, ref_state, init_g):
    """A distributed step's metrics and weights against the single-process
    step's, at the whole-step bars: loss scalars relative, D leaves
    max-abs, each G leaf's update (less its weight decay, lr 10) in
    relative L2, outside dp.* and the leaves that get no gradient (the key
    projections' biases, and at init every layer behind a zero-initialised
    flow coupling's output conv). Returns (ok, the worst of each)."""
    loss_rel = max(abs(metrics[k] - v) / max(abs(v), 1e-12)
                   for k, v in ref_metrics.items() if k.startswith(
                       ("loss/", "grad_norm")))
    d_err = max(float((d[k].float().cpu() - v.float().cpu()).abs().max())
                for k, v in ref_state.net_d.state_dict().items())
    g_rel, g_worst, still, compared = 0.0, None, 0, 0
    for k, v in ref_state.net_g.state_dict().items():
        if k.startswith("dp."):
            continue
        p0 = init_g[k].double()
        upd_ref = v.double().cpu() - 0.9 * p0
        size = float(upd_ref.norm())
        if size < 1e-6:
            still += 1
            continue
        rel = float((g[k].double().cpu() - 0.9 * p0 - upd_ref).norm()) / size
        if rel > g_rel:
            g_rel, g_worst = rel, k
        compared += 1
    worst = {"loss_rel": loss_rel, "d_max_abs": d_err,
             "g_update_rel_l2": g_rel, "g_worst_leaf": g_worst,
             "g_leaves_compared": compared,
             "g_leaves_without_gradient": still}
    return (loss_rel <= STEP_LOSS_REL and d_err <= STEP_D_ATOL
            and g_rel <= STEP_G_REL and compared >= 100), worst


def _single_step(cfg, seed, batch, draws, cudnn):
    """The single-process step on the whole batch, from the ranks' weights
    (the worker's `seeded_state`) and the same draws, under the cuDNN
    setting `cudnn`."""
    from mb_istft_vits_torch.train import step as tstep

    state = _dist_worker().seeded_state(cfg, "cuda", seed, dp_dropout=0.0)
    with _dist_worker().cudnn(cudnn):
        metrics = {k: float(v) for k, v in tstep.train_step(
            state, {k: v.cuda() for k, v in batch.items()},
            tstep.StepDraws(*(None if v is None else v.cuda()
                              for v in draws))).items()}
    return state, metrics


def _accumulated_step(cfg, seed, batch, draws, cudnn, parts=2):
    """The data-parallel step's arithmetic in one process: the batch in
    `parts` equal parts, each part's forward and backward on its rows
    alone, their gradients summed at 1/parts each (the KL and duration
    terms at the global batch's normalisation, as the ranks scale them),
    then one AdamW step per net; the metrics are the parts' means, as the
    ranks log them. Same weights, draws and cuDNN setting as
    `_single_step`."""
    import torch

    from mb_istft_vits_torch.train import step as tstep

    state = _dist_worker().seeded_state(cfg, "cuda", seed, dp_dropout=0.0)
    batch = tstep.prep_batch({k: v.cuda() for k, v in batch.items()}, cfg)
    rows = batch["x"].shape[0] // parts
    halves = [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
              for i in range(parts)]
    draws = [tstep.StepDraws(*(None if v is None else
                               v[i * rows:(i + 1) * rows].cuda()
                               for v in draws)) for i in range(parts)]

    def update(optim, params, clip=None):
        norm = torch.linalg.vector_norm(torch.stack(
            [p.grad.norm() for p in params if p.grad is not None]))
        tstep.optimizer_step(optim, params, state.learning_rate(), clip)
        return float(norm)

    with _dist_worker().cudnn(cudnn):
        outs = [tstep.g_forward(state, h, d) for h, d in zip(halves, draws)]
        ys = [tstep.real_slice(state, h, o[4]) for h, o in zip(halves, outs)]
        state.optim_d.zero_grad()
        loss_d = 0.0
        for y, o in zip(ys, outs):
            loss = tstep.d_loss(state, y, o[0].transpose(1, 2)) / parts
            loss.backward()
            loss_d += float(loss)
        metrics = {"loss/d/total": loss_d, "grad_norm_d": update(
            state.optim_d, list(state.net_d.parameters()))}
        sums = [torch.stack([o[5].float().sum(), o[6].float().sum()])
                for o in outs]
        total_sums = sum(sums)
        state.optim_g.zero_grad()
        for h, o, y, local in zip(halves, outs, ys, sums):
            losses = tstep.g_losses(state, h, o, y)
            scale = parts * local / total_sums
            losses["loss/g/dur"] = losses["loss/g/dur"] * scale[0]
            losses["loss/g/kl"] = losses["loss/g/kl"] * scale[1]
            losses["loss/g/total"] = sum(losses.values())
            (losses["loss/g/total"] / parts).backward()
            for k, v in losses.items():
                metrics[k] = metrics.get(k, 0.0) + float(v) / parts
        metrics["grad_norm_g"] = update(
            state.optim_g, list(state.net_g.parameters()),
            cfg.train.grad_clip_value)
    return state, metrics


def _draws(cfg, batch, seed):
    """Seeded global draws of a batch: posterior noise and slice starts."""
    import torch

    from mb_istft_vits_torch.train import step as tstep

    d = cfg.data
    gen = torch.Generator().manual_seed(seed)
    t_spec = (batch["wav"].shape[1] - (d.filter_length - d.hop_length)) \
        // d.hop_length
    b = batch["x"].shape[0]
    eps = torch.randn(b, t_spec, cfg.model.inter_channels, generator=gen)
    top = torch.clamp(batch["spec_lengths"].cpu().long()
                      - cfg.train.segment_size // d.hop_length + 1, min=1)
    ids = (torch.rand(b, generator=gen) * top).to(torch.int32)
    return tstep.StepDraws(eps, ids)


def _torchrun_cli(cfg, cwd, name, steps):
    """Start the training CLI under `python -m torch.distributed.run
    --nproc_per_node 1` on the card (NCCL, world 1); its Popen, output
    merged into stdout."""
    from mb_istft_vits_torch.parallel import dryrun

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    port = str(dryrun.free_port())
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "1", "--master_port", port, "-m", "mb_istft_vits_torch.train",
         "-c", cfg, "-m", name, "--max-steps", str(steps)],
        cwd=cwd, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _logged_steps(model_dir):
    with open(os.path.join(model_dir, "train.log")) as f:
        return {int(m.group(1)): json.loads(m.group(2)) for m in
                re.finditer(r"step (\d+): (\{.*\})", f.read())}


def phase_ddp(root):
    """Data-parallel training on the one card: two ranks spawned on cuda:0
    over gloo (tests/torch_port_dist_worker.py), the flagship at full
    width, DDP_ROWS rows a rank (the train phase's 16 in all): a compared
    step for each cuDNN setting of DDP_COMPARE, on seeded global draws at
    lr 10 / eps 10 with every dropout off, each held to the whole-step
    bars: with cuDNN off against the single-process step on the whole
    batch, with cuDNN deterministic against the single-process sum of the
    two 8-row halves (the 16-row step's distance reported beside it);
    then DDP_STEPS timed steps at the config's lr (and eps 10, see
    timed_cfg) from the same weights: two eager warm-ups, the capture of
    the three stage graphs, a replay. Each route (the graphs, eager) is
    timed and profiled on those graphs (the worker's `timed_routes`), and
    a replay is held to the eager data-parallel step (`replay_vs_eager`):
    under cuDNN's default algorithms on the same graphs, at the
    train_graphs phase's bars; under the deterministic ones on a capture
    of its own, bit for bit. Checks the ranks' weights bit-equal after
    every step, equal metrics, one MAS launch a rank a step. Records each
    rank's step ms (both ranks share the card: not a scaling number), and
    the ms of an all-reduce of one buffer of every weight's bytes, on its
    own outside the steps. Then the CLI under torchrun at world 1 (NCCL)
    against the same CLI run plainly, and what NCCL says to two ranks on
    one card."""
    import concurrent.futures
    import dataclasses

    import torch

    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.parallel.dryrun import tiny_batch, tiny_config
    from mb_istft_vits_torch.train import checkpoint
    from mb_istft_vits_torch.train.__main__ import main as train_main

    worker = _dist_worker()
    from torch_port_data import write_tiny_dataset

    cfg = Config.from_json(CONFIG)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, p_dropout=0.0),
        train=dataclasses.replace(cfg.train, batch_size=DDP_ROWS))
    cmp_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, learning_rate=10.0, eps=10.0))
    # the timed steps: the config's lr, and the compared steps' eps, so
    # that the replay under cuDNN's default algorithms is compared on the
    # graphs they captured (eps is a constant of the captured update; the
    # lr a tensor it reads)
    timed_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, eps=cmp_cfg.train.eps))
    init = worker.seeded_state(cfg, "cpu", DDP_SEED)
    g0 = {k: v.clone() for k, v in init.net_g.state_dict().items()}
    del init
    batch = {k: v.cpu() for k, v in
             train_batch(cfg, 2 * DDP_ROWS, seed=4).items()}
    draws = _draws(cfg, batch, seed=5)
    # the CLI under torchrun, world 1 over NCCL, while this process takes
    # the single-process steps (it is done before the ranks start)
    cli_root = os.path.join(root, "ddp_cli")
    os.makedirs(cli_root)
    cli_cfg = write_tiny_dataset(cli_root)
    t1 = time.perf_counter()
    torchrun = _torchrun_cli(cli_cfg, cli_root, "nccl", 3)
    try:
        singles = [_single_step(cmp_cfg, DDP_SEED, batch, draws, c)
                   for c in DDP_COMPARE]
        halves = _accumulated_step(cmp_cfg, DDP_SEED, batch, draws,
                                   DDP_COMPARE[1])
        out_nccl = torchrun.communicate(timeout=300)[0]
    finally:
        if torchrun.poll() is None:
            torchrun.kill()
            torchrun.wait()
    rc_nccl, torchrun_s = torchrun.returncode, time.perf_counter() - t1
    out = os.path.join(root, "ddp")
    nccl_out = os.path.join(root, "nccl_two")
    os.makedirs(out)
    os.makedirs(nccl_out)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # NCCL binds each rank to its card at init: two ranks on one card
        # fail there, seconds before the gloo ranks reach their steps
        nccl_try = pool.submit(worker.launch, dict(
            world=2, device="cuda:0", backend="nccl", timeout=60,
            cfg=tiny_config(), seed=0, batch=tiny_batch(2), draws=None),
            nccl_out, 120)
        ranks = worker.launch(dict(
            world=2, device="cuda:0", backend="gloo", timeout=300,
            cfg=cmp_cfg, seed=DDP_SEED, batch=batch, draws=draws,
            dp_dropout=0.0, compare=DDP_COMPARE, steps=DDP_STEPS,
            restart=timed_cfg, routes=DDP_ROUTE_STEPS,
            graph_compare=GRAPH_COMPARE), out, 600)
        try:
            nccl_try.result()
            nccl = {"refused": False, "error": None}
        except RuntimeError as e:
            lines = [ln for ln in str(e).splitlines()
                     if "Duplicate GPU" in ln or "Error" in ln]
            nccl = {"refused": True, "error": lines[-3:]}
    ranks_s = time.perf_counter() - t0
    _add_child_launches(ranks, "main.ddp_replays")
    r0, r1 = ranks
    compared = [_compare_step(r0["compared"][i]["metrics"], r0["g"][i],
                              r0["d"][i], metrics, state, g0)
                for i, (state, metrics) in enumerate(singles)]
    # the deterministic step against the two 8-row halves summed, and
    # those halves against the 16 rows at once
    vs_halves = _compare_step(r0["compared"][1]["metrics"], r0["g"][1],
                              r0["d"][1], halves[1], halves[0], g0)
    halves_vs_whole = _compare_step(
        halves[1], halves[0].net_g.state_dict(),
        halves[0].net_d.state_dict(), singles[1][1], singles[1][0], g0)
    del singles, halves
    torch.cuda.empty_cache()
    timed = {r["rank"]: [s["host_ms"] for s in r["steps"]] for r in ranks}
    all_steps = [r["compared"] + r["steps"] for r in ranks]

    # the same CLI plainly, in this process
    cwd = os.getcwd()
    os.chdir(cli_root)
    try:
        rc_plain = train_main(["-c", cli_cfg, "-m", "plain", "--max-steps",
                               "3"])
    finally:
        os.chdir(cwd)
    logs = {n: _logged_steps(os.path.join(cli_root, "logs", n))
            for n in ("nccl", "plain")}
    with open(os.path.join(cli_root, "logs", "nccl", "train.log")) as f:
        nccl_log = f.read()
    rel = {s: max(abs(logs["nccl"][s][k] - v) / max(abs(v), 1e-12)
                  for k, v in logs["plain"][s].items()
                  if k != "steps_per_sec")
           for s in logs["plain"] if s in logs["nccl"]}
    # the stage graphs: the timed steps' routes, the replay against the
    # eager data-parallel step (under cuDNN's default algorithms on the
    # timed steps' graphs, under the deterministic ones on a capture of
    # its own), a profiled warm step of each route
    routes_want = (["eager"] * WARMUP_ITERS + ["capture"]
                   + ["replay"] * (DDP_STEPS - WARMUP_ITERS - 1))
    default = [r["graph_compare"][0] for r in ranks]
    deterministic = [r["graph_compare"][1] for r in ranks]
    held = [_hold_replay(c) for c in default]
    routes = {name: [r["routes"][name] for r in ranks]
              for name in ("graph", "eager")}
    graph_checks = {
        "timed_steps_warm_capture_replay": all(
            [st["route"] for st in r["steps"]] == routes_want
            for r in ranks),
        "replay_bit_equal_to_eager_deterministic": all(
            c["replay"]["bit_equal"] for c in deterministic),
        "replay_losses_and_d_within_bars_default": all(
            h["losses_and_d"] for h in held),
        "replay_g_updates_within_bar_or_eager_noise_default": all(
            h["g_updates"] for h in held),
        "default_compared_on_the_timed_steps_graphs": all(
            not c["captured"] and c["captures"] == 0 for c in default),
        "three_graphs_a_step_replayed": all(
            c["graphs_a_step"] == 3 and c["replay_route"] == "replay"
            for c in default + deterministic) and all(
            c["captures"] == 1 for c in deterministic),
        "replay_mas_once": all(c["replay_mas_launches"] == 1
                               for c in default + deterministic),
        "warm_step_3_graph_launches": all(
            r["launches"]["cuda_graph_launch_calls"] == 3
            for r in routes["graph"]),
        "warm_step_few_kernel_launches": all(
            r["launches"]["cuda_launch_kernel_calls"] < DDP_KERNEL_LAUNCHES
            for r in routes["graph"]),
        "routes_mas_once_a_step_and_seen": all(
            r["mas_kernels_seen"] and set(r["mas_launches_per_step"]) == {1}
            for rs in routes.values() for r in rs),
        "torchrun_nccl_world_1_captured_3_graphs":
            "captured a step of 3 graph(s)" in nccl_log,
    }
    checks = {
        # see DDP_COMPARE
        "step_matches_single_process": compared[0][0],
        "deterministic_step_matches_two_8_row_halves": vs_halves[0],
        "ranks_bit_identical_every_step": all(
            a["digest"] == b["digest"] for a, b in zip(*all_steps)),
        "metrics_equal_across_ranks": all(
            a["metrics"] == b["metrics"] for a, b in zip(*all_steps)),
        "mas_once_per_rank_per_step": all(
            s["mas_launches"] == 1 for steps in all_steps for s in steps),
        "timed_steps_finite": all(math.isfinite(v) for r in ranks
                                  for s in r["steps"]
                                  for v in s["metrics"].values()),
        "torchrun_nccl_world_1_exit_0_with_a_pair": rc_nccl == 0
        and checkpoint.saved_steps(os.path.join(
            cli_root, "logs", "nccl"))[-1:] == [3]
        and "process group: 1 rank(s) over nccl" in nccl_log,
        "plain_cli_exit_0": rc_plain == 0,
        "world_1_step_1_equals_plain": sorted(rel) == [1, 2, 3]
        and rel[1] <= STEP_LOSS_REL,
        **graph_checks,
    }
    route_ms = {name: {r["rank"]: {k: r["routes"][name][k] for k in (
        "step_ms_events", "launches", "device_busy_share", "device_ms")}
        for r in ranks} for name in ("graph", "eager")}
    emit("ddp", ranks=2, rows_per_rank=DDP_ROWS, global_batch=2 * DDP_ROWS,
         step_route="graphs: a rank's step is 3 CUDA graphs (the stages of "
                    "train/step.py) with its 2 all-reduces run eagerly "
                    "between them; warm-ups, capture, replays as routed",
         nvidia_smi=nvidia_smi(),
         backend="gloo", device="cuda:0 (both ranks: one card shared, so "
         "the step times are not a scaling number)",
         routes=route_ms,
         graphs={r["rank"]: r["routes"]["graphs"] for r in ranks},
         graph_compare={"default": default, "deterministic": deterministic},
         timed_step_routes=[st["route"] for st in r0["steps"]],
         step_ms_per_rank=timed,
         step_ms_median_per_rank={r: statistics.median(v)
                                  for r, v in timed.items()},
         compared_step_ms_per_rank={r["rank"]: [s["host_ms"] for s in
                                                r["compared"]]
                                    for r in ranks},
         allreduce_ms=r0["allreduce_ms"],
         allreduce_bytes_per_step=r0["allreduce_bytes"],
         compared={json.dumps(c): worst for c, (_, worst) in
                   zip(DDP_COMPARE, compared)},
         deterministic_vs_two_8_row_halves=vs_halves[1],
         two_8_row_halves_vs_16_rows_deterministic=halves_vs_whole[1],
         ranks_seconds=ranks_s,
         rank_seconds_by_part={r["rank"]: r["seconds"] for r in ranks},
         nccl_two_ranks_one_card=nccl,
         torchrun_world_1={"exit_code": rc_nccl, "seconds": torchrun_s,
                           "metrics_rel_to_plain_by_step": rel,
                           "tail": out_nccl[-400:]},
         checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"ddp checks failed: {failed}")


TP_ROWS = DDP_ROWS  # the (1 x 2) mesh's one data replica: 8 rows
TP_KERNEL_LAUNCHES = 25  # a warm replayed 2-D rank step launches fewer
# rows a rank of the dryrun's flagship half (JAX's batch 64 over its two
# data-parallel ranks), run beside the 2-D step
TP_FLAGSHIP_ROWS = 32


def phase_tp():
    """`parallel.dryrun.dryrun_multichip(2)` on the card (two data-parallel
    ranks sharing cuda:0 over gloo: the tiny step, then the flagship half,
    the flagship at TP_FLAGSHIP_ROWS rows a rank in bf16, its warm-up
    steps and stage graphs' capture) and, beside it, the 2-D step
    (`parallel.tp`) at the flagship's widths: two ranks on cuda:0 over
    gloo as a (1 x 2) data x model mesh, TP_ROWS rows (the worker's steps,
    as in the ddp phase): a compared step (lr 10 / eps 10, every dropout
    off, seeded draws, cuDNN deterministic) held to the single-process
    step at the ddp phase's bars; DDP_STEPS timed steps (two eager
    warm-ups, the capture of the five stage graphs, a replay); each
    route timed and profiled; a replay held to the eager 2-D step bit for
    bit under the deterministic algorithms and within the train_graphs
    bars under the default ones; the worker's `tp_checks` (5 stages, 4
    collectives a replayed step, a save and resume then a step equal to
    the uninterrupted step). Checks the ranks bit-identical after every
    step, one MAS launch a rank a step, 5 graph launches and fewer than
    TP_KERNEL_LAUNCHES kernel launches a warm rank step, the profiled MAS
    kernels equal to the counts, the shards and moments shard-shaped as
    `param_shardings` says."""
    import concurrent.futures
    import dataclasses

    import torch

    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.parallel import param_shardings
    from mb_istft_vits_torch.parallel.dryrun import dryrun_multichip
    from mb_istft_vits_torch.weights import load_generator_pth

    worker = _dist_worker()
    deterministic = GRAPH_COMPARE[1]
    cfg = Config.from_json(CONFIG)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, p_dropout=0.0),
        train=dataclasses.replace(cfg.train, batch_size=TP_ROWS))
    cmp_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, learning_rate=10.0, eps=10.0))
    # the timed steps: the config's lr and the compared eps (as in ddp)
    timed_cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, eps=cmp_cfg.train.eps))
    init = worker.seeded_state(cfg, "cpu", DDP_SEED)
    g0 = {k: v.clone() for k, v in init.net_g.state_dict().items()}
    want = {f"{p}.{k}": dim for p, net in (("g", init.net_g),
                                           ("d", init.net_d))
            for k, dim in param_shardings(net, 2).items() if dim is not None}
    del init
    batch = {k: v.cpu() for k, v in
             train_batch(cfg, TP_ROWS, seed=4).items()}
    draws = _draws(cfg, batch, seed=5)
    single, single_metrics = _single_step(cmp_cfg, DDP_SEED, batch, draws,
                                          deterministic)
    torch.cuda.empty_cache()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    t0 = time.perf_counter()
    # its two ranks run beside the 2-D step's two, all on the card
    dry_run = pool.submit(dryrun_multichip, 2, device="cuda")
    with tempfile.TemporaryDirectory() as out:
        ranks = worker.launch(dict(
            world=2, n_model=2, device="cuda:0", backend="gloo", timeout=600,
            cfg=cmp_cfg, seed=DDP_SEED, batch=batch, draws=draws,
            dp_dropout=0.0, compare=[deterministic], steps=DDP_STEPS,
            restart=timed_cfg, routes=DDP_ROUTE_STEPS,
            graph_compare=GRAPH_COMPARE, checks={}), out, 900)
        g = load_generator_pth(os.path.join(out, "G_1.pth"))
        d = torch.load(os.path.join(out, "D_1.pth"), weights_only=True)[
            "model"]
    t1 = time.perf_counter()
    dry = dry_run.result()
    pool.shutdown()
    t2 = time.perf_counter()
    _add_child_launches(ranks, "main.tp_replays")
    _add_child_launches(dry["ranks"])
    ok_step, worst = _compare_step(ranks[0]["compared"][0]["metrics"], g, d,
                                   single_metrics, single, g0)
    del single, g, d
    routes_want = (["eager"] * WARMUP_ITERS + ["capture"]
                   + ["replay"] * (DDP_STEPS - WARMUP_ITERS - 1))
    all_steps = [r["compared"] + r["steps"] for r in ranks]
    default = [r["graph_compare"][0] for r in ranks]
    det = [r["graph_compare"][1] for r in ranks]
    held = [_hold_replay(c) for c in default]
    routes = {name: [r["routes"][name] for r in ranks]
              for name in ("graph", "eager")}
    tp = [r["checks"] for r in ranks]
    (flag,) = dry["flagship"]

    def shard_shaped(sharded):
        if sorted(sharded) != sorted(want):
            return False
        for k, leaf in sharded.items():
            shard = list(leaf["whole"])
            shard[want[k]] //= 2
            if leaf["shard"] != shard or leaf["moments"] != [shard, shard]:
                return False
        return True

    checks = {
        "dryrun_ok": dry["backend"] == "gloo" and dry["kind"] == "data=2"
        and dry["route"] == "graphs",
        "dryrun_flagship_captured": flag["kind"] == "data=2"
        and flag["captured"] and flag["graphs_a_step"] == 3
        and flag["rows_per_rank"] == TP_FLAGSHIP_ROWS,
        "step_matches_single_process": ok_step,
        "ranks_bit_identical_every_step": all(
            a["digest"] == b["digest"] for a, b in zip(*all_steps)),
        "metrics_equal_across_ranks": all(
            a["metrics"] == b["metrics"] for a, b in zip(*all_steps)),
        "mas_once_per_rank_per_step": all(
            s["mas_launches"] == 1 for steps in all_steps for s in steps),
        "timed_steps_warm_capture_replay": all(
            [st["route"] for st in r["steps"]] == routes_want
            for r in ranks),
        "timed_steps_finite": all(math.isfinite(v) for r in ranks
                                  for s in r["steps"]
                                  for v in s["metrics"].values()),
        "replay_bit_equal_to_eager_deterministic": all(
            c["replay"]["bit_equal"] for c in det),
        "replay_losses_and_d_within_bars_default": all(
            h["losses_and_d"] for h in held),
        "replay_g_updates_within_bar_or_eager_noise_default": all(
            h["g_updates"] for h in held),
        "default_compared_on_the_timed_steps_graphs": all(
            not c["captured"] and c["captures"] == 0 for c in default),
        "five_graphs_a_step_replayed": all(
            c["graphs_a_step"] == 5 and c["replay_route"] == "replay"
            for c in default + det) and all(
            c["captures"] == 1 for c in det),
        "replay_mas_once": all(c["replay_mas_launches"] == 1
                               for c in default + det),
        "warm_step_5_graph_launches": all(
            r["launches"]["cuda_graph_launch_calls"] == 5
            for r in routes["graph"]),
        "warm_step_few_kernel_launches": all(
            r["launches"]["cuda_launch_kernel_calls"] < TP_KERNEL_LAUNCHES
            for r in routes["graph"]),
        "routes_mas_once_a_step_and_seen": all(
            r["mas_kernels_seen"] and set(r["mas_launches_per_step"]) == {1}
            for rs in routes.values() for r in rs),
        "routed_in_5_stages": all(c["routed"] and c["stages"] == 5
                                  for c in tp),
        "replayed_step_4_collectives": all(
            c["collectives"] == {"all_reduce": 2, "all_gather": 2}
            and c["counted_route"] == "replay" for c in tp),
        "key_records_n_model": all(
            c["n_model"] == 2 and all(k[9] == 2 for k in c["keys"])
            for c in tp),
        "shards_and_moments_shard_shaped": all(
            shard_shaped(r["sharded"]) for r in ranks),
        "ten_conv_weights_on_dim_0": len([
            k for k, dim in want.items()
            if dim == 0 and k.endswith(("weight", "weight_v"))]) >= 10,
        "save_resume_step_equals_uninterrupted": all(
            c["resumed"] == c["saved_at"]
            and c["resumed_step_equals_uninterrupted"]
            and c["resumed_finite"] for c in tp),
    }
    emit("tp", dryrun=dict(dry, seconds=t2 - t0),
         flagship_half={
             "rows_per_rank": flag["rows_per_rank"],
             "capture_bytes_per_rank": flag["pool_bytes"],
             "capture_seconds_per_rank": flag["capture_seconds"],
             "peak_bytes_per_rank": flag["peak_bytes"]},
         step_route="graphs: a rank's 2-D step is 5 CUDA graphs (the stages "
                    "of train/step.py) with its 2 all-reduces and 2 "
                    "all-gathers run eagerly between them",
         nvidia_smi=nvidia_smi(),
         mesh="data 1 x model 2, gloo, both ranks on cuda:0 (one card "
              "shared: the step times are not a scaling number)",
         rows=TP_ROWS, seconds_2d=t1 - t0,
         routes={name: {r["rank"]: {k: r["routes"][name][k] for k in (
             "step_ms_events", "launches", "device_busy_share",
             "device_ms")} for r in ranks} for name in ("graph", "eager")},
         graphs={r["rank"]: r["routes"]["graphs"] for r in ranks},
         graph_compare={"default": default, "deterministic": det},
         timed_step_routes=[st["route"] for st in ranks[0]["steps"]],
         step_ms_per_rank={r["rank"]: [s["host_ms"] for s in r["steps"]]
                           for r in ranks},
         compared_step_ms_per_rank={r["rank"]: r["compared"][0]["host_ms"]
                                    for r in ranks},
         rank_seconds_by_part={r["rank"]: r["seconds"] for r in ranks},
         tp_checks=[{k: v for k, v in c.items() if k != "keys"}
                    for c in tp],
         sharded_weights=len(want), worst=worst,
         checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"tp checks failed: {failed}")


OVERFIT_STEPS = 150  # the JAX script's default
SURFACE_T, SURFACE_T_KV = 400, 160  # the surface phase's query and memory
SURFACE_BAR = 1e-4  # card against CPU, max-abs, f32 with TF32 off


def phase_overfit():
    """The JAX package's overfit gate (`scripts/overfit_check.py`) on the
    card, through the port's `overfit_check.run` in this process: the tiny
    multi-band config trained for OVERFIT_STEPS steps on one seeded batch.
    Checks the mel loss's drop below 0.7 of its first value, finite losses
    and one MAS launch on the card a step; then a fresh state's third
    step, profiled (device ms, cudaLaunchKernel calls)."""
    import torch

    from mb_istft_vits_torch import overfit_check
    from mb_istft_vits_torch.ops import mas
    from mb_istft_vits_torch.train import step as tstep

    before = dict(mas.launch_counts)
    result = overfit_check.run(OVERFIT_STEPS, "cuda")
    launched = {k: mas.launch_counts[k] - before[k] for k in before}

    cfg = overfit_check.tiny_config()
    state = tstep.create_train_state(cfg, torch.device("cuda"), seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             overfit_check.synthetic_batch(cfg).items()}
    for _ in range(WARMUP_ITERS + 1):  # warm-ups, the capture
        tstep.train_step(state, batch)
    profile = _dist_worker().profiled(state, batch)
    ms = result["step_ms"]
    checks = {
        "mel_below_0.7_of_first": result["last_mel"]
        < overfit_check.DROP * result["first_mel"],
        "losses_finite": all(math.isfinite(v)
                             for v in result["metrics"].values()),
        "mas_on_the_card_each_step":
        launched["mas_fused"] + launched["mas_fwd"] == OVERFIT_STEPS,
        "profiled_mas_kernels_seen": profile["mas_kernels_seen"],
    }
    emit("overfit", steps=OVERFIT_STEPS, first_mel=result["first_mel"],
         last_mel=result["last_mel"],
         mel_ratio=result["last_mel"] / result["first_mel"],
         metrics=result["metrics"],
         mas_shape=[int(batch["x"].shape[0]), int(batch["spec"].shape[1]),
                    int(batch["x"].shape[1])],
         mas_launches=launched, first_step_ms=ms[0],
         step_ms_median=statistics.median(ms[1:]), profile=profile,
         device_ms=profile["device_ms"],
         cuda_launch_kernel_calls=profile["cuda_launch_kernel_calls"],
         checks=checks)
    del state, batch
    torch.cuda.empty_cache()
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"overfit checks failed: {failed}")


def phase_surface():
    """The library surface the shipped configs do not run, at the
    flagship's widths (hidden, filter, heads, layers, kernel of
    ljs_mb_istft_vits.json), seeded weights, eval mode, f32 with TF32 off:
    the TransformerDecoder on [2, C, 400] against a [2, C, 160] memory,
    MultiHeadAttention with heads_share=False, with block_length 4, with
    the proximal bias and init, and as cross-attention, ConvReluNorm with
    a random projection, and the three timing signals, each on the card
    against the same weights and inputs on the CPU (max-abs <=
    SURFACE_BAR; ms on the card). Then `utils.profile_trace` around one
    flagship Synthesizer.infer on the card: its trace must name a CUDA
    kernel."""
    import copy
    import glob

    import torch
    from torch.autograd import DeviceType

    from mb_istft_vits_torch import nn as pnn
    from mb_istft_vits_torch import ops as pops
    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.models import Synthesizer
    from mb_istft_vits_torch.utils import profile_trace

    cfg = Config.from_json(CONFIG)
    m = cfg.model
    hc, heads = m.hidden_channels, m.n_heads
    gen = torch.Generator().manual_seed(11)

    def mask_of(lengths, t):  # [B, 1, T]
        return (torch.arange(t)[None] < torch.tensor(lengths)[:, None]
                ).float()[:, None]

    x = torch.randn((2, hc, SURFACE_T), generator=gen)
    h = torch.randn((2, hc, SURFACE_T_KV), generator=gen)
    x_mask = mask_of([SURFACE_T, 311], SURFACE_T)
    h_mask = mask_of([SURFACE_T_KV, 97], SURFACE_T_KV)
    self_mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)
    cross_mask = h_mask.unsqueeze(2) * x_mask.unsqueeze(-1)
    torch.manual_seed(12)
    crn = pnn.ConvReluNorm(hc, hc, hc, 5, 3)
    with torch.no_grad():  # the zero projection would make it the identity
        crn.proj.weight.copy_(0.05 * torch.randn(crn.proj.weight.shape,
                                                 generator=gen))
    cases = {
        "transformer_decoder": (pnn.TransformerDecoder(
            hc, m.filter_channels, heads, m.n_layers, m.kernel_size),
            (x, x_mask, h, h_mask)),
        "mha_heads_share_false": (pnn.MultiHeadAttention(
            hc, hc, heads, heads_share=False), (x, self_mask)),
        "mha_block_length_4": (pnn.MultiHeadAttention(
            hc, hc, heads, block_length=4), (x, self_mask)),
        "mha_proximal_bias_init": (pnn.MultiHeadAttention(
            hc, hc, heads, window_size=None, proximal_bias=True,
            proximal_init=True), (x, pnn.subsequent_mask(SURFACE_T))),
        "mha_cross_attention": (pnn.MultiHeadAttention(
            hc, hc, heads, window_size=None), (x, cross_mask, h)),
        "conv_relu_norm": (crn, (x, x_mask)),
        "get_timing_signal_1d": (lambda x: pops.get_timing_signal_1d(
            SURFACE_T, hc, device=x.device), (x,)),
        "add_timing_signal_1d": (pops.add_timing_signal_1d, (x,)),
        "cat_timing_signal_1d": (pops.cat_timing_signal_1d, (x,)),
    }
    rows = {}
    with torch.no_grad():
        for name, (fn, args) in cases.items():
            card_fn = fn
            if isinstance(fn, torch.nn.Module):
                fn.eval()
                card_fn = copy.deepcopy(fn).cuda()
            card_args = tuple(a.cuda() for a in args)
            ref = fn(*args)
            out = card_fn(*card_args)
            torch.cuda.synchronize()
            rows[name] = {
                "shape": list(out.shape),
                "max_abs_err": float((out.cpu() - ref).abs().max()),
                "ms": time_ms(lambda: card_fn(*card_args)),
                "finite": bool(torch.isfinite(out).all())}

    torch.manual_seed(13)
    net = Synthesizer(m).cuda().eval()
    ids = torch.randint(1, m.n_vocab, (1, 120), generator=gen).cuda()
    lengths = torch.tensor([120]).cuda()
    with tempfile.TemporaryDirectory() as trace_dir:
        with torch.no_grad(), profile_trace(trace_dir) as prof:
            net.infer(ids, lengths, max_frames=1000,
                      generator=torch.Generator("cuda").manual_seed(14))
            torch.cuda.synchronize()
        traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
        events = []
        for path in traces:
            with open(path) as f:
                events += json.load(f)["traceEvents"]
        trace_bytes = sum(os.path.getsize(p) for p in traces)
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3
    del net
    torch.cuda.empty_cache()
    checks = {f"{k}_within_{SURFACE_BAR}": r["max_abs_err"] <= SURFACE_BAR
              and r["finite"] for k, r in rows.items()}
    checks["trace_names_a_cuda_kernel"] = len(traces) == 1 and bool(kernels)
    emit("surface", widths={"hidden": hc, "filter": m.filter_channels,
                            "heads": heads, "layers": m.n_layers,
                            "kernel": m.kernel_size},
         t=SURFACE_T, t_kv=SURFACE_T_KV, modules=rows,
         trace={"files": len(traces), "bytes": trace_bytes,
                "kernel_events": len(kernels),
                "distinct_kernels": len(set(kernels)),
                "first_kernels": sorted(set(kernels))[:3],
                "device_ms": device_ms},
         checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"surface checks failed: {failed}")


# the measurement tools at the flagship's widths, short repetitions: the
# batch-64 train tools one after another (each holds a batch-64 step's
# memory), the others started together beside them
BENCH_TRAIN_TOOLS = {
    "bench_train": ["--batch", "64", "--steps", "3", "--device-spec",
                    "--feed-host", "--flops"],
    "profile_step": ["--batch", "64", "--steps", "2", "--top-k", "12"],
    "flops_analysis": ["--batch", "64"],
}
BENCH_TOOLS = {
    "bench_mas": ["--n", "5", "--reps", "3"],
    "bench": ["--runs", "5", "--calls", "5"],
    "bench_batch": ["--reps", "2"],
    "bench_stream": ["--reps", "2"],
    "bench_chunk_decode": ["--reps", "2"],
    "bench_microbatch": ["--rounds", "3", "--floor"],
    "bench_export": ["--reps", "3"],
    "profile_infer": [],
}
MFU_RANGE = (0.0, 1.05)
BENCH_LAUNCHES = {}  # tool -> its MAS launches in the bench phase


def _tool_record(text):
    """The last JSON object line of a tool's output, or None."""
    for line in reversed(text.splitlines()):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def phase_bench(root):
    """Each measurement tool as a user runs it, a child process on the card
    (two torch threads each): exit code 0, its JSON's device the card,
    every device field of the tool (its DEVICE_FIELDS) finite and > 0,
    bench_train's mfu in (0, 1.05], MAS launched by each train tool's step
    and every MAS kernel by bench_mas. Each tool's MAS launches are kept
    apart from the main path's (BENCH_LAUNCHES): bench_mas times the
    forced routes in bursts."""
    import importlib

    import torch

    from mb_istft_vits_torch.utils.timing import field_values

    work = os.path.join(root, "bench")
    os.makedirs(work)
    env = {"OMP_NUM_THREADS": "2"}
    args = {**BENCH_TRAIN_TOOLS, **BENCH_TOOLS}
    args["profile_step"] = [*args["profile_step"], "--logdir",
                            os.path.join(work, "prof")]
    t0 = time.perf_counter()
    results, running = {}, {}
    try:
        for name in BENCH_TOOLS:
            running[name] = _tool(name, *args[name], cwd=work, env=env)
        for name in BENCH_TRAIN_TOOLS:
            results[name] = _finish(*_tool(name, *args[name], cwd=work,
                                           env=env))
        for name in list(running):
            results[name] = _finish(*running.pop(name))
    finally:  # no child outlives a failure here
        for proc, out in running.values():
            _finish(proc, out, timeout=0)
    seconds = time.perf_counter() - t0
    records = {name: _tool_record(text) for name, (_, text) in results.items()}
    kind = torch.cuda.get_device_name(0)
    device_fields, checks = {}, {}
    for name, rec in records.items():
        ok = results[name][0] == 0 and rec is not None
        if ok:
            fields = importlib.import_module(
                f"mb_istft_vits_torch.{name}").DEVICE_FIELDS
            values = [v for f in fields for v in field_values(rec, f)]
            device_fields[name] = values
            ok = (rec["device"]["platform"] == "gpu"
                  and rec["device"]["kind"] == kind
                  and all(isinstance(v, (int, float)) and math.isfinite(v)
                          and v > 0 for v in values))
            BENCH_LAUNCHES[name] = rec["mas_launches"]
        checks[f"{name}_ok"] = ok
    mfu = (records.get("bench_train") or {}).get("mfu")
    checks["mfu_in_range"] = (mfu is not None
                              and MFU_RANGE[0] < mfu <= MFU_RANGE[1])
    # a train step launches the fused kernel or the pair; bench_mas each
    checks["step_tools_launched_mas"] = all(
        BENCH_LAUNCHES.get(t, {}).get("mas_fused", 0)
        + BENCH_LAUNCHES.get(t, {}).get("mas_fwd", 0) > 0
        for t in BENCH_TRAIN_TOOLS)
    checks["bench_mas_launched_every_kernel"] = all(
        v > 0 for v in BENCH_LAUNCHES.get("bench_mas", {"none": 0}).values())
    emit("bench", seconds=seconds, records=records,
         mas_launches_by_tool=BENCH_LAUNCHES,
         exit_codes={k: rc for k, (rc, _) in results.items()},
         tails={k: text[-600:] for k, (rc, text) in results.items()
                if rc != 0 or records[k] is None},
         checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"bench checks failed: {failed}")


def phase_serve_mesh():
    """The serving mesh: `SynthesisModule(mesh=[cuda:0, cuda:0])` (two mesh
    positions on the one card, sharing its replica) against the
    single-device module, the same seeded weights: synthesize_batch of
    SERVE_BATCH lines with seeded noise, decode_chunks_batched and
    batched decode_spec_join of one latent; within JAX's mesh bar
    (tests/test_infer.py:277, atol 5e-4); ms of each, warm."""
    import numpy as np

    from mb_istft_vits_torch.infer.synthesis import SynthesisModule

    single = SynthesisModule(CONFIG, seed=0, device="cuda")
    mesh = SynthesisModule(CONFIG, seed=0, mesh=["cuda:0", "cuda:0"])
    texts = _texts(SERVE_BATCH)
    z, _, _ = single.prepare_shared_latents(texts[0], seed=3)
    runs = {
        "synthesize_batch": lambda m: m.synthesize_batch(texts, seed=7)[0],
        "decode_chunks_batched": lambda m: [m.decode_chunks_batched(z)],
        "decode_spec_join": lambda m: [m.decode_spec_join(z, batched=True)],
    }
    ms, err = {}, {}
    for name, fn in runs.items():
        outs = {}
        for label, m in (("single", single), ("mesh", mesh)):
            fn(m)  # first call per shape
            t0 = time.perf_counter()
            outs[label] = fn(m)
            ms[f"{name}_{label}"] = (time.perf_counter() - t0) * 1e3
        a, b = outs["single"], outs["mesh"]
        err[name] = (max(float(np.abs(x - y).max()) for x, y in zip(a, b))
                     if len(a) == len(b) and all(
                         x.shape == y.shape for x, y in zip(a, b))
                     else float("inf"))
    checks = {f"{k}_within_5e-4": v <= 5e-4 for k, v in err.items()}
    checks["two_positions_one_replica"] = (
        len(mesh._replicas) == 2
        and mesh._replicas[0][1] is mesh._replicas[1][1])
    emit("serve_mesh", mesh=["cuda:0", "cuda:0"], batch=SERVE_BATCH, ms=ms,
         max_abs_err=err, checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"serve_mesh checks failed: {failed}")


def _eager_request(sm, text, seed, bucket):
    """A warm request as the serving module made it before its graphs:
    the infer body called directly at `bucket` (one launch per kernel),
    the same inputs and draws as `synthesize(text, seed=seed)`, then the
    same fetch. -> (audio, timings)."""
    import numpy as np
    import torch

    from mb_istft_vits_torch.infer import programs

    t0 = time.perf_counter()
    x, xl = sm._pad_ids_cached(sm.text_to_ids(text))
    sid = sm._sid_rows(1, None)
    gen, w_eps = sm._draws(x.shape, seed)
    ns, ls, nsw = (sm._knob(v, sm.device) for v in KNOBS)
    td = time.perf_counter()
    with torch.no_grad():
        pcm, y_lengths = programs.infer(
            sm.model, x, xl, sid, ns, ls, nsw, sm._eps(gen, 1, bucket),
            w_eps, max_frames=bucket)
    pending = sm._fetch([pcm[0], y_lengths])
    ts = time.perf_counter()
    host = pending()
    te = time.perf_counter()
    audio = host[0].astype(np.float32)[: int(host[1][0]) * sm.hop_length]
    audio = audio / 32767.0
    return audio, {"dispatch": ts - td, "sync": te - ts, "total": te - t0,
                   "rtf": (te - t0) / (audio.size / sm.sampling_rate)}


def _launches(prof):
    return {k: prof[k] for k in ("cuda_launch_kernel_calls",
                                 "cuda_graph_launch_calls",
                                 "cuda_memcpy_calls")}


def _graph_numbers(sm, pairs, check):
    """The flagship's headline sentence and each warmup pair on the graphs
    against the direct eager call of the same bodies: launches a request,
    dispatch, sync, e2e RTF, the device busy union a call."""
    import numpy as np
    import torch

    from mb_istft_vits_torch.bench import TEXT
    from mb_istft_vits_torch.infer import programs
    from mb_istft_vits_torch.utils.timing import busy_ms

    for _ in range(3):  # the frames-per-token ratio settles
        sm.synthesize(TEXT, seed=0)
    graph = [sm.synthesize(TEXT, seed=0) for _ in range(GRAPH_REQUESTS)]
    bucket = graph[-1][1]["frame_bucket"]
    eager = [_eager_request(sm, TEXT, 0, bucket)
             for _ in range(GRAPH_REQUESTS)]
    check("headline_graph_equals_eager_body", all(
        np.array_equal(g[0], e[0]) for g, e in zip(graph, eager)))
    calls = {"graphs": lambda: sm.synthesize(TEXT, seed=0),
             "eager": lambda: _eager_request(sm, TEXT, 0, bucket)}
    headline = {"frame_bucket": bucket,
                "audio_seconds": graph[-1][1]["audio_seconds"]}
    for mode, runs in (("graphs", graph), ("eager", eager)):
        prof = profile_call(calls[mode])
        busy = busy_ms(calls[mode], sm.device, calls=5)
        headline[mode] = {
            **{f"{k}_ms": statistics.median(t[k] for _, t in runs) * 1e3
               for k in ("dispatch", "sync", "total")},
            "e2e_rtf": statistics.median(t["rtf"] for _, t in runs),
            "busy_ms": statistics.median(busy), "busy_ms_calls": busy,
            "launches": _launches(prof),
            "device_busy_share": prof["device_busy_share"]}
    per_pair = []
    sid = sm._sid_rows(1, 0)
    for tb, fb in pairs:
        x = sm._to_device(np.ones((1, tb), np.int64))
        xl = sm._to_device(np.asarray([tb], np.int64))
        eps = sm._eps(torch.Generator(sm.device).manual_seed(0), 1, fb)
        knobs = [sm._knob(v, sm.device) for v in KNOBS]

        def on_graphs():
            pcm, _ = sm._infer(x, xl, sid, *KNOBS, fb, None, None, eps=eps)
            sm._fetch([pcm[0]])()

        def direct():
            with torch.no_grad():
                pcm, _ = programs.infer(sm.model, x, xl, sid, *knobs, eps,
                                        None, max_frames=fb)
            sm._fetch([pcm[0]])()

        row = {"pair": [tb, fb]}
        for mode, fn in (("graphs", on_graphs), ("eager", direct)):
            prof = profile_call(fn)
            busy = busy_ms(fn, sm.device, calls=3)
            row[mode] = {"busy_ms": statistics.median(busy),
                         "wall_ms": prof["wall_ms_profiled"],
                         "launches": _launches(prof),
                         "device_busy_share": prof["device_busy_share"]}
        per_pair.append(row)
    return {"headline": headline, "pairs": per_pair}


def phase_serve_graphs(smi):
    """The serving programs as CUDA graphs (infer/graphs.py): for each
    model, warmup() a pair at a time, each pair's replays against direct
    calls of the same bodies at two knob settings, a seeded repeat, a new
    shape captured once; the flagship's numbers in f32 and bf16; the mesh
    batch against the single device's."""
    import numpy as np
    import torch

    from mb_istft_vits_torch.bench import TEXT
    from mb_istft_vits_torch.infer import programs
    from mb_istft_vits_torch.infer.synthesis import (
        SynthesisModule,
        _next_bucket,
    )

    checks = {}

    def check(name, ok):
        checks[name] = checks.get(name, True) and bool(ok)

    models = {"flagship_f32": (CONFIG, torch.float32, None, TEXT),
              "flagship_bf16": (CONFIG, torch.bfloat16, None, TEXT),
              "ms_speaker_5": (MS_CONFIG, torch.float32, 5, ms_rows()[0][1]),
              "istft": (ISTFT_CONFIG, torch.float32, None, TEXT)}
    report = {}
    for name, (config, dtype, speaker, text) in models.items():
        sm = SynthesisModule(config, None, None, 0, dtype, device="cuda")
        row = report[name] = {}
        pairs = [(tb, _next_bucket(int(tb * sm._frames_per_token),
                                   sm.FRAME_BUCKETS))
                 for tb in sm.TEXT_BUCKETS]
        row["warmup"] = []
        for pair in pairs:
            before, t0 = sm.graphs.captures, time.perf_counter()
            sm.warmup([pair])
            row["warmup"].append({"pair": list(pair),
                                  "capture_s": time.perf_counter() - t0,
                                  "graphs": sm.graphs.captures - before})
        row["pool_bytes_after_warmup"] = sm.graphs.pool_bytes()
        warm = sm.graphs.captures
        check("warmup_captures_probe_and_infer_per_pair",
              warm == len(pairs) + len({tb for tb, _ in pairs}))
        sid = sm._sid_rows(1, speaker)
        gen = torch.Generator().manual_seed(0)
        for i, (tb, fb) in enumerate(pairs):
            x = torch.randint(1, sm.cfg.n_vocab, (1, tb), generator=gen
                              ).cuda()
            xl = torch.tensor([tb - i - 1]).cuda()
            for values in (KNOBS, OTHER_KNOBS):
                eps = sm._eps(torch.Generator("cuda").manual_seed(i), 1, fb)
                ns, ls, nsw = (sm._knob(v, sm.device) for v in values)
                got = sm._infer(x, xl, sid, *values, fb, None, None, eps=eps)
                frames = sm._predict_frames(x, xl, sid, values[1], values[2],
                                            None)
                with torch.no_grad():
                    want = programs.infer(sm.model, x, xl, sid, ns, ls, nsw,
                                          eps, None, max_frames=fb)
                    want_frames = programs.probe(sm.model, x, xl, sid, ls,
                                                 nsw, None)
                check("replays_bit_equal_to_direct_calls",
                      all(map(torch.equal, got, want))
                      and torch.equal(frames, want_frames))
        check("knob_change_replays_the_same_graph",
              sm.graphs.captures == warm)
        _fresh_bucket_state(sm)
        first, t1 = sm.synthesize(text, speaker, seed=0)
        _fresh_bucket_state(sm)
        again, t2 = sm.synthesize(text, speaker, seed=0)
        check("seeded_repeat_bit_equal",
              t1["frame_bucket"] == t2["frame_bucket"]
              and np.array_equal(first, again))
        z = torch.randn((1, 100, sm.cfg.inter_channels), device="cuda",
                        dtype=dtype)
        before = sm.graphs.captures
        outs = [sm._decode_pcm(z, speaker) for _ in range(2)]
        with torch.no_grad():
            direct = programs.decode_pcm(sm.model, z, sm._sid_rows(1,
                                                                   speaker))
        check("new_shape_captured_once", sm.graphs.captures == before + 1
              and all(torch.equal(o, direct) for o in outs))
        if name.startswith("flagship"):
            row.update(_graph_numbers(sm, pairs, check))
        row.update(graphs=len(sm.graphs), captures=sm.graphs.captures,
                   replays=sm.graphs.replays,
                   pool_bytes=sm.graphs.pool_bytes())
        del sm
        torch.cuda.empty_cache()

    single = SynthesisModule(CONFIG, seed=0, device="cuda")
    mesh = SynthesisModule(CONFIG, seed=0, mesh=["cuda:0", "cuda:0"])
    texts = _texts(SERVE_BATCH)
    a, _ = single.synthesize_batch(texts, seed=7)
    b, _ = mesh.synthesize_batch(texts, seed=7)
    mesh_err = (max(float(np.abs(x - y).max()) for x, y in zip(a, b))
                if len(a) == len(b) and all(x.shape == y.shape
                                            for x, y in zip(a, b))
                else float("inf"))
    check("mesh_batch_within_5e-4_of_single", mesh_err <= 5e-4)
    check("mesh_positions_share_one_infer_graph", len(
        [k for k in mesh.graphs.keys() if k[0] == "infer"]) == 1)
    emit("serve_graphs", nvidia_smi=smi, weights="random (seed 0)",
         models=report, mesh={"max_abs_err": mesh_err,
                              "bit_equal": mesh_err == 0.0},
         checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"serve_graphs checks failed: {failed}")


EXPORT_TEXTS = 4  # texts held bit for bit to the live module
EXPORT_RTF_REQUESTS = 12  # requests timed in each of live and artifact


def _text_bucket(sm, text):
    from mb_istft_vits_torch.infer.synthesis import _next_bucket

    return _next_bucket(len(sm.text_to_ids(text)), sm.TEXT_BUCKETS)


def _bucket_texts(sm, n):
    """{text bucket: its first n filelist texts} of the two text buckets
    most of the first 200 lines fall in."""
    by_tb = {}
    for text in _texts(200):
        by_tb.setdefault(_text_bucket(sm, text), []).append(text)
    tbs = sorted(by_tb, key=lambda b: (-len(by_tb[b]), b))[:2]
    return {tb: by_tb[tb][:n] for tb in sorted(tbs)}


def _probe_bucket(sm, text, sid=None):
    """The frame bucket the live module's duration probe gives `text`."""
    x, xl = sm._pad_ids(sm.text_to_ids(text))
    gen, w_eps = sm._draws(x.shape, 0)
    return sm._frames_bucket(x, xl, sm._sid_rows(1, sid), 1.0, 0.8, w_eps)


def _live_at(sm, art, text, *args, **kw):
    """The live module's request at the frame buckets the artifact holds
    for the text's bucket, the bucket from the probe."""
    old = sm.FRAME_BUCKETS
    sm.FRAME_BUCKETS = tuple(art._buckets_for(len(art.text_to_ids(text)))[1])
    _fresh_bucket_state(sm)
    try:
        return sm.synthesize(text, *args, **kw)
    finally:
        sm.FRAME_BUCKETS = old


def _artifact_eager(art, *args, **kw):
    """The artifact's request with its programs called directly, no graph,
    and its knobs on the CPU: what it served before its graph cache."""
    from mb_istft_vits_torch.infer.export import _scalar

    art._run = lambda key, program, *a: program(art.params, *a)
    art._knob = _scalar
    try:
        return art.synthesize(*args, **kw)
    finally:
        del art._run, art._knob


def _exported(sm, root, name, pairs):
    """export_serving of `pairs` into root/name, then load_serving onto
    cuda:0: (artifact, export s, load s, file bytes)."""
    from mb_istft_vits_torch.infer.export import export_serving, load_serving

    out = os.path.join(root, name)
    t0 = time.perf_counter()
    export_serving(sm, out, pairs)
    t1 = time.perf_counter()
    art = load_serving(out, device="cuda:0")
    t2 = time.perf_counter()
    sizes = {f: os.path.getsize(os.path.join(out, f))
             for f in sorted(os.listdir(out))}
    programs = sum(f.endswith(".pt2") for f in sizes)
    return art, {"pairs": [list(p) for p in pairs], "programs": programs,
                 "export_s": t1 - t0, "export_s_per_program":
                 (t1 - t0) / programs, "load_s": t2 - t1, "bytes": sizes}


def phase_export(smi):
    """The exported serving artifact (infer/export.py) of the flagship at
    full width, f32, seeded random weights. Two (text, frame) pairs traced
    on the card, of the two text buckets most filelist lines fall in (each
    with the largest frame bucket the live probe gives its texts), loaded
    with load_serving: EXPORT_TEXTS filelist texts, half of each text
    bucket, at seeds 0.. bit-equal to the live
    module's synthesize at the same seed and frame bucket, a seeded
    repeat bit-equal, two unseeded requests different, frames past every
    bucket refused; one pair traced with the module on the CPU and served
    on cuda:0 (within one int16 step of the card-traced artifact); one
    pair of the bf16 module against the live bf16 module; one pair of the
    12-speaker model with speakers 0 and 5 against its live module. The
    artifact replays its programs as CUDA graphs (its GraphCache); each
    request is held bit for bit to the artifact's eager call of the same
    programs (no graph, CPU knobs: _artifact_eager). Reports export and
    load seconds, the bytes of params.pt and of each .pt2, the median RTF
    of EXPORT_RTF_REQUESTS requests in the live module, the artifact and
    its eager call, the launches a request in each (two graph launches in
    the artifact's), and the artifact's graphs."""
    import numpy as np
    import torch

    from mb_istft_vits_torch.infer.synthesis import SynthesisModule

    checks, diff = {}, {}

    def check(name, ok):
        checks[name] = checks.get(name, True) and bool(ok)

    def err(a, b):
        return float(np.abs(a - b).max()) if a.shape == b.shape else None

    live = SynthesisModule(CONFIG, seed=0, device="cuda")
    by_tb = _bucket_texts(live, EXPORT_RTF_REQUESTS // 2)
    pairs = [(tb, max(_probe_bucket(live, t) for t in ts))
             for tb, ts in by_tb.items()]
    texts = [t for row in zip(*by_tb.values()) for t in row]  # tb by tb
    tb = pairs[0][0]  # the CPU-traced and the bf16 pairs' text bucket
    files = {}
    with tempfile.TemporaryDirectory() as root:
        art, files["cuda"] = _exported(live, root, "cuda", pairs)
        for i, text in enumerate(texts[:EXPORT_TEXTS]):
            want, tw = _live_at(live, art, text, seed=i)
            got, tg = art.synthesize(text, seed=i)
            check("f32_bit_equal_to_live", np.array_equal(got, want)
                  and tg["frame_bucket"] == tw["frame_bucket"])
            diff.setdefault("f32_vs_live", []).append(err(got, want))
            again, _ = art.synthesize(text, seed=i)
            check("seeded_repeat_bit_equal", np.array_equal(again, got))
            eager, _ = _artifact_eager(art, text, seed=i)
            check("replay_bit_equal_to_eager_call",
                  np.array_equal(eager, got))
            diff.setdefault("replay_vs_eager_call", []).append(
                err(got, eager))
        r1, _ = art.synthesize(texts[0])
        r2, _ = art.synthesize(texts[0])
        check("unseeded_requests_differ",
              r1.shape != r2.shape or not np.array_equal(r1, r2))
        try:
            art.synthesize(texts[0], seed=0, length_scale=50.0)
            check("overflow_refused", False)
        except ValueError:
            check("overflow_refused", True)

        # traced on the CPU, served on the card
        cpu_live = SynthesisModule(CONFIG, seed=0, device="cpu")
        moved, files["cpu_traced"] = _exported(cpu_live, root, "cpu",
                                               pairs[:1])
        del cpu_live
        diff["cpu_traced_vs_card_traced"] = []
        for i, text in enumerate(texts):
            if _text_bucket(live, text) == tb:
                diff["cpu_traced_vs_card_traced"].append(err(
                    moved.synthesize(text, seed=i)[0],
                    art.synthesize(text, seed=i)[0]))
        check("cpu_traced_within_one_int16_step",
              diff["cpu_traced_vs_card_traced"] and all(
                  e is not None and e <= 1.0 / 32767 + 1e-9
                  for e in diff["cpu_traced_vs_card_traced"]))

        # the median RTF and launches a request, live against artifact
        # (every shape has run above)
        rtf = {"live": [], "artifact": [], "artifact_eager": []}
        for i, text in enumerate(texts):
            rtf["live"].append(_live_at(live, art, text, seed=i)[1]["rtf"])
            rtf["artifact"].append(art.synthesize(text, seed=i)[1]["rtf"])
            rtf["artifact_eager"].append(
                _artifact_eager(art, text, seed=i)[1]["rtf"])

        def live_call():
            return _live_at(live, art, texts[0], seed=0)

        def art_call():
            return art.synthesize(texts[0], seed=0)

        # a profile's last graph replay loses its device records: each
        # graph profile has a trailing request, cut from it
        profiles = {
            "live": profile_call(live_call, trailing=live_call),
            "artifact": profile_call(art_call, trailing=art_call),
            "artifact_eager": profile_call(
                lambda: _artifact_eager(art, texts[0], seed=0))}
        check("artifact_request_two_graph_launches",
              profiles["artifact"]["cuda_graph_launch_calls"] == 2)
        artifact_graphs = {"keys": [list(map(str, k[:3]))
                                    for k in art.graphs.keys()],
                           "captures": art.graphs.captures,
                           "replays": art.graphs.replays,
                           "capture_seconds": list(
                               art.graphs.capture_seconds.values()),
                           "pool_bytes": art.graphs.pool_bytes()}
        del art, moved, live
        torch.cuda.empty_cache()

        # bf16: the live bf16 module's own frame bucket
        bf = SynthesisModule(CONFIG, None, None, 0, torch.bfloat16,
                             device="cuda")
        bf_pair = (tb, max(_probe_bucket(bf, t) for t in by_tb[tb]))
        art, files["bf16"] = _exported(bf, root, "bf16", [bf_pair])
        for i, text in enumerate(by_tb[tb][:EXPORT_TEXTS]):
            want, tw = _live_at(bf, art, text, seed=i)
            got, tg = art.synthesize(text, seed=i)
            diff.setdefault("bf16_vs_live", []).append(err(got, want))
            check("bf16_same_bucket", tg["frame_bucket"] == tw["frame_bucket"])
        del art, bf
        torch.cuda.empty_cache()

        # the 12-speaker model, speakers 0 and 5
        ms = SynthesisModule(MS_CONFIG, seed=0, device="cuda")
        _, ms_text = ms_rows()[0]
        ms_pair = (_text_bucket(ms, ms_text),
                   max(_probe_bucket(ms, ms_text, sid) for sid in (0, 5)))
        art, files["multi_speaker"] = _exported(ms, root, "ms", [ms_pair])
        outs = []
        for sid in (0, 5):
            want, tw = _live_at(ms, art, ms_text, sid, seed=3)
            got, tg = art.synthesize(ms_text, sid, seed=3)
            check("multi_speaker_bit_equal_to_live",
                  np.array_equal(got, want)
                  and tg["frame_bucket"] == tw["frame_bucket"])
            diff.setdefault("multi_speaker_vs_live", []).append(
                err(got, want))
            outs.append(got)
        check("speakers_differ", outs[0].shape != outs[1].shape
              or not np.array_equal(*outs))
        del art, ms
        torch.cuda.empty_cache()
    params_bytes = files["cuda"]["bytes"]["params.pt"]
    check("programs_well_under_the_weights", all(
        n < params_bytes / 10 for f, n in files["cuda"]["bytes"].items()
        if f.endswith(".pt2")))
    emit("export", config=os.path.relpath(CONFIG, REPO), nvidia_smi=smi,
         weights="random (seed 0)", pairs=pairs,
         texts=EXPORT_TEXTS, files=files, max_abs_err=diff,
         bf16_bit_equal=all(e == 0.0 for e in diff["bf16_vs_live"]),
         median_rtf={k: statistics.median(v) for k, v in rtf.items()},
         rtf=rtf, profile_request=profiles,
         launches_request={k: _launches(v) for k, v in profiles.items()},
         artifact_graphs=artifact_graphs, checks=checks)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise AssertionError(f"export checks failed: {failed}")


def main() -> int:
    smi = run_phase(phase_device)
    import torch

    from mb_istft_vits_torch.device import disable_tf32
    from mb_istft_vits_torch.ops import mas

    disable_tf32()
    run_phase(phase_build)
    checks = run_phase(phase_kernels)

    # the main path: the training forward, training steps of both models,
    # the training CLI and serving; the counts show which kernels it
    # launched
    mas.reset_launch_counts()
    neg_cent, mask = run_phase(phase_forward)
    flagship = run_phase(phase_train)
    with tempfile.TemporaryDirectory() as root:  # the SDP config
        run_phase(phase_train_sdp, flagship, root)
        net_ms = run_phase(phase_train_ms, flagship[0])
        run_phase(phase_eval_ms, net_ms)
        del net_ms
        torch.cuda.empty_cache()
        run_phase(phase_train_graphs, root)
        torch.cuda.empty_cache()
        run_phase(phase_train_cli)
        torch.cuda.empty_cache()
        trained = run_phase(phase_train_data, root)
        torch.cuda.empty_cache()
        run_phase(phase_tools, root, trained)
        torch.cuda.empty_cache()
        run_phase(phase_ddp, root)
        run_phase(phase_tp)
        run_phase(phase_overfit)
        run_phase(phase_surface)
        run_phase(phase_bench, root)
        # last: the serving modules pin cuDNN's deterministic algorithms
        # for the rest of the process
        run_phase(phase_serve)
        run_phase(phase_serve_graphs, smi)
        run_phase(phase_export, smi)
        run_phase(phase_serve_ms)
        run_phase(phase_serve_istft)
        run_phase(phase_serve_sdp, root)
        run_phase(phase_serve_bf16)
        run_phase(phase_serve_mesh)
    launches = dict(mas.launch_counts)
    for k, v in CHILD_LAUNCHES.items():  # the spawned ranks' own counts
        launches[k] += v
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
            "launches_by_path": {
                "main": launches[name],
                **{path: counts.get(name, 0)
                   for path, counts in REPLAYED_LAUNCHES.items()}, **{
                    f"bench.{tool}": counts.get(name, 0)
                    for tool, counts in BENCH_LAUNCHES.items()}},
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
