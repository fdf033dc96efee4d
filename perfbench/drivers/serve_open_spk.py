"""Open-loop serving traffic of a multi-speaker model with the stochastic
duration predictor: independent users send single sentences, each in its
line's own voice, at a fixed Poisson rate through the port's
micro-batching front end (`serve.microbatch.MicroBatcher`) to one
`infer.synthesis.SynthesisModule` in float32, with default synthesis
knobs and no per-request seed. A coalesced group mixes speakers.

The schedule, the client, the latencies, the sample and the gap numbers
are `serve_open`'s: every seed gets the same work (weights from the
cell's fixed `weights_seed` with its `weight_overrides`, the decoder's
`dec.conv_post.weight` scaled by the cell's `conv_post_scale`; the same
gaps and lines in the same order), and the seed draws the checked
sample. A table line is `speaker|cleaned text`.

Set-up loads the module and runs, ahead of the window, every line alone
in its voice, then the table in groups of each batch bucket up to
`max_batch` (in the table's order, and again longest first, so that the
largest buckets are reached), then the traffic itself for `warm_s`
seconds, so that the window captures what the duration predictor's draws
can still reach and no more.

The check recomputes each sampled answer with the plain reference
(`perfbench.reference.vits_hifigan.infer`) on the same weights, speaker
and draws. The module draws each decode's noise from a generator seeded
with the request's seed (0, the front end's default): first the
duration predictor's w_eps at [rows, ids, 2] of the batch bucket and the
text bucket, then the prior's at [rows, channels, frames] of the frame
bucket. A lone request's frame bucket is the one its timings report; a
coalesced request's rows are its batch (`batch_order`, `batch_sids`)
padded to the module's batch bucket with one-id rows of speaker 0, its
text bucket the module's bucket of its longest row, and its frame bucket
the module's bucket of the most frames the reference predicts among those
rows under their own w_eps."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from perfbench.drivers.serve_open import (Load, _next_bucket, _pad,
                                          gap_numbers, latencies_ms, pick,
                                          schedule)
from perfbench.reference import vits_hifigan as reference
from perfbench.reference.precision import float32
from perfbench.yardstick import corpus, stats, weights


class Line(str):
    """A table line's text (what the front end reports back in
    `batch_order`), carrying its speaker."""

    sid: int

    @classmethod
    def parse(cls, line: str) -> "Line":
        sid, text = line.split("|", 1)
        out = cls(text)
        out.sid = int(sid)
        return out


def _rows(r):
    """(texts, speakers, row) of the request's decode, or None where its
    row is ambiguous (its text twice in one batch)."""
    t = r.get("timings") or {}
    if t.get("batched", 1) == 1:
        return [r["text"]], [r["text"].sid], 0
    order = t["batch_order"]
    if order.count(r["text"]) != 1:
        return None
    return order, list(t["batch_sids"]), order.index(r["text"])


def reference_audio(r, module, p, m, table, device):
    """The reference's (frames, waveform on the int16 grid, float64 numpy)
    of the answered request r, on the program's draws (module
    docstring)."""
    texts, sids, row = _rows(r)
    nb = _next_bucket(len(texts), module.BATCH_BUCKETS, 8)
    ids = ([corpus.text_ids(t, table, False) for t in texts]
           + [np.zeros(1, np.int64)] * (nb - len(texts)))
    sids = torch.tensor(sids + [0] * (nb - len(texts)), device=device)
    t_x = _next_bucket(max(len(i) for i in ids), module.TEXT_BUCKETS)
    gen = torch.Generator(device).manual_seed(0)
    w_eps = torch.randn((nb, t_x, 2), generator=gen,
                        device=device).transpose(1, 2)
    if nb == 1:
        frames = int(r["timings"]["frame_bucket"])
    else:
        x, xl = _pad(ids, device)
        pred = reference.predicted_frames(p, m, x, xl, sids,
                                          w_eps[:, :, :x.shape[1]])
        frames = min(_next_bucket(int(pred.max()), module.FRAME_BUCKETS),
                     module.MAX_FRAMES)
    eps = torch.randn((nb, m["inter_channels"], frames), generator=gen,
                      device=device)[row:row + 1]
    x, xl = _pad([ids[row]], device)
    o, y_len = reference.infer(p, m, x, xl, sids[row:row + 1], eps,
                               w_eps[row:row + 1, :, :x.shape[1]], frames)
    n = int(y_len[0])
    wave = torch.clamp(o[0, :n * module.hop_length], -1.0, 1.0)
    return n, np.round(wave.double().cpu().numpy() * 32767.0) / 32767.0


def warm(module, lines, frames, max_batch: int) -> None:
    """Every line alone in its voice, then the table in groups of each
    batch bucket up to `max_batch`, in its order and longest first."""
    for line in lines:
        module.synthesize(line, line.sid, seed=0)
    longest = [lines[i] for i in np.argsort(frames)[::-1]]
    for nb in sorted({_next_bucket(n, module.BATCH_BUCKETS, 8)
                      for n in range(2, max_batch + 1)}):
        for order in (lines, longest):
            for k in range(0, len(order), nb):
                group = order[k:k + nb]
                if len(group) > 1:
                    module.synthesize_batch(group, [g.sid for g in group],
                                            seed=0)


def run(ctx) -> Dict:
    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.infer.synthesis import SynthesisModule
    from mb_istft_vits_torch.models import Synthesizer
    from mb_istft_vits_torch.serve.microbatch import MicroBatcher

    wl, conf, device = ctx.workload, ctx.config, ctx.device
    c = conf["corpus"]
    with open(f"{corpus.CORPUS}/{c['serve_texts']}.txt",
              encoding="utf-8") as f:
        lines = [Line.parse(s.rstrip("\n")) for s in f][:wl.get("texts")]
    cfg = Config.from_json(ctx.config_path)
    with torch.device("meta"):
        leaves = [(k, tuple(v.shape))
                  for k, v in Synthesizer(cfg.model).state_dict().items()]
    p = weights.make(leaves, wl["weights_seed"], device,
                     cfg.model.hidden_channels, wl.get("weight_overrides"))
    p["dec.conv_post.weight"] = p["dec.conv_post.weight"] \
        * wl["conv_post_scale"]
    module = SynthesisModule(ctx.config_path, params=p, device=device)
    front = MicroBatcher(module, max_batch=wl["max_batch"],
                         max_wait_ms=wl["max_wait_ms"])
    front.start()
    load = Load(lambda line: front.synthesize(line, line.sid),
                wl["workers"])
    rate = wl["rate_per_s"]
    ctx.log("module loaded")
    m = dict(conf["model"], n_vocab=cfg.model.n_vocab)
    symbols = corpus.symbols(c["module"])
    try:
        with torch.no_grad():
            gen = torch.Generator(device).manual_seed(0)
            frames = []
            for k in range(0, len(lines), 64):
                chunk = lines[k:k + 64]
                x, xl = _pad([corpus.text_ids(t, symbols, False)
                              for t in chunk], device)
                w_eps = torch.randn((len(chunk), 2, x.shape[1]),
                                    generator=gen, device=device)
                sids = torch.tensor([t.sid for t in chunk], device=device)
                frames += reference.predicted_frames(p, m, x, xl, sids,
                                                     w_eps).tolist()
        warm(module, lines, frames, wl["max_batch"])
        ctx.log(f"signatures warm: {module.graphs.captures} captures")
        offsets, texts = schedule(rate, ctx.seconds, len(lines))
        warm_offsets, warm_texts = schedule(rate, wl["warm_s"], len(lines))
        warmed = load.run(warm_offsets, warm_texts, lines)
        failed_warm = sum(1 for r in warmed if "answered" not in r)
        ctx.sync()
        ctx.log(f"warm: {len(warmed)} requests, {failed_warm} unanswered, "
                f"{module.graphs.captures} captures")
        setup_s = time.time() - ctx.t_start
        captures = module.graphs.captures
        with ctx.tracer:
            with ctx.tracer.window():
                records = load.run(offsets, texts, lines)
                ctx.sync()
            if ctx.tracer.enabled:
                with ctx.tracer.trailing():
                    front.synthesize(lines[0], lines[0].sid)
                    ctx.sync()
        captures = module.graphs.captures - captures
    finally:
        front.stop()
        load.close()
    memory_peak = ctx.memory_peak()
    ctx.check_modules()
    lat = latencies_ms(records)
    failed = sum(v is None for v in lat)
    ctx.log(f"window: {len(records)} requests, {failed} missing, late "
            f"{load.late_s * 1e3:.1f} ms, {captures} captures")

    def audio(r):
        return reference_audio(r, module, p, m, symbols, device)

    # `pick` finds a request's row by its text, as `_rows` does
    picked = pick(records, wl["sample"], np.random.default_rng([ctx.seed, 2]))
    with torch.no_grad(), float32():
        ref = [audio(r) for r in picked]
    numbers = gap_numbers([r["audio"] for r in picked], ref,
                          module.hop_length)
    ctx.log("reference done")
    timed = [r for r in records if "timings" in r]
    decodes = sum(1.0 / r["timings"].get("batched", 1) for r in timed)
    dispatch = sorted({id(r["timings"]): r["timings"]["dispatch"] * 1e3
                       for r in timed
                       if "dispatch" in r["timings"]}.values())
    return {
        "attempted": len(records), "failed": failed,
        "numbers": numbers,
        "memory_peak": memory_peak,
        "end_to_end": {"setup_s": setup_s,
                       "serve_p95_ms": stats.percentile(lat, 95),
                       "serve_p50_ms": stats.percentile(lat, 50)},
        "counters": {"requests": len(records), "decodes": decodes,
                     "captures": captures, "dispatch_ms": dispatch,
                     "late_ms": load.late_s * 1e3},
        "check": {"picked": picked, "ref": ref, "audio": audio,
                  "hop": module.hop_length},
    }
