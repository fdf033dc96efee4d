"""Open-loop serving traffic: independent users send single sentences at
a fixed Poisson rate through the port's micro-batching front end
(`serve.microbatch.MicroBatcher`, its default knobs) to one
`infer.synthesis.SynthesisModule` in float32, as production callers
send them: default synthesis knobs, no per-request seed.

Every seed gets the same work: the weights are drawn from the cell's
fixed `weights_seed` (with its `weight_overrides`), so every text speaks
the same frames, and the requests come in the same order, the
exponential distribution's quantiles at the cell's rate as the gaps and
the frozen test lines in turn as the texts. The seed draws the requests
the check samples. Set-up loads the module with the benchmark's weights
and runs the traffic's own mix once, open loop at the same rate, so that
the signatures the window reaches are captured before it
(`warm_signatures` first, then the traffic for `warm_s` seconds). A
request is timed from the moment it was due to the moment its audio is
in the caller's hands; one that fails or never answers is missing.

After the window a sample of the answered requests drawn from the seed,
with the longest among them, is computed again by the plain reference
(`perfbench.reference.vits.infer`) on the same weights and noise, its
durations its own. The module draws the prior's noise itself, from a
generator seeded with the request's seed (0, the front end's default) at
the decode's shape: [rows, channels, frames] of the batch bucket and the
frame bucket it chose. The reference redraws that noise on the same
device: a lone request's frame bucket is the one its timings report; a
coalesced request's rows are its batch (`batch_order`) padded to the
module's batch bucket with one-id rows, and its frame bucket is the
module's bucket (`FRAME_BUCKETS`) of the largest frame count the
reference predicts among those rows."""

from __future__ import annotations

import bisect
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import vits
from perfbench.reference.precision import float32
from perfbench.yardstick import corpus, stats, weights

WAIT_AFTER_S = 60.0  # how long the last requests may take past the window
PCM = 32767.0  # the int16 grid the module's audio is on


def schedule(rate: float, seconds: float, n_texts: int):
    """(offsets in seconds, text index) of every request due in
    [0, seconds): round(rate * seconds) requests, the gaps the
    exponential distribution's quantiles at `rate`, the texts runs of the
    table, both in one fixed order, the same for every seed."""
    n = max(1, int(round(rate * seconds)))
    order = np.random.default_rng(0)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = order.permutation(gaps * (seconds / gaps.sum()))
    offsets = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return offsets, order.permutation(np.arange(n) % n_texts)


class Load:
    """Sends the scheduled requests open loop through `send`, from one
    dispatcher, each call blocking in a pool thread; records each
    request's due time, answer time, result and error."""

    def __init__(self, send, workers: int = 64):
        self.send = send
        self.pool = ThreadPoolExecutor(max_workers=workers)

    def run(self, offsets, texts, table) -> List[Dict]:
        records = [dict(text=table[i]) for i in texts]
        done = threading.Semaphore(0)
        start = time.perf_counter() + 0.05

        def one(rec):
            try:
                rec["audio"], rec["timings"] = self.send(rec["text"])
                rec["answered"] = time.perf_counter()
            except Exception as e:  # the request failed: it is missing
                rec["error"] = repr(e)
            finally:
                done.release()

        late = 0.0
        for rec, off in zip(records, offsets):
            rec["due"] = start + float(off)
            wait = rec["due"] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            else:
                late = max(late, -wait)
            self.pool.submit(one, rec)
        deadline = time.perf_counter() + WAIT_AFTER_S
        for _ in records:
            if not done.acquire(timeout=max(0.0, deadline
                                            - time.perf_counter())):
                break
        self.late_s = late
        return records

    def close(self):
        self.pool.shutdown(wait=True)


def latencies_ms(records) -> List[Optional[float]]:
    return [(r["answered"] - r["due"]) * 1e3 if "answered" in r else None
            for r in records]


def _next_bucket(n: int, buckets, granule: int = 64) -> int:
    i = bisect.bisect_left(buckets, n)
    if i < len(buckets):
        return buckets[i]
    return int(math.ceil(n / granule) * granule)


def pick(records, sample: int, rng) -> List[Dict]:
    """A sample of the answered requests whose row is known, drawn from
    `rng`, with the longest among them."""
    answered = [r for r in records if "answered" in r
                and _row(r) is not None]
    if not answered:
        return []
    longest = max(range(len(answered)),
                  key=lambda i: len(answered[i]["audio"]))
    others = [i for i in range(len(answered)) if i != longest]
    chosen = [longest] + [int(i) for i in rng.choice(
        others, size=min(sample - 1, len(others)), replace=False)]
    return [answered[i] for i in chosen]


def reference_audio(r, module, p, m, table, by_token, device):
    """The reference's (frames, waveform on the int16 grid, float64 numpy)
    of the answered request r, on the program's noise (module
    docstring)."""
    rows, row = _row(r)
    nb = _next_bucket(len(rows), module.BATCH_BUCKETS, 8)
    if len(rows) == 1:
        frames = int(r["timings"]["frame_bucket"])
    else:
        x, xl = _pad([corpus.text_ids(t, table, by_token) for t in rows]
                     + [np.zeros(1, np.int64)] * (nb - len(rows)), device)
        pred = vits.predicted_frames(p, m, x, xl, None)
        frames = min(_next_bucket(int(pred.max()), module.FRAME_BUCKETS),
                     module.MAX_FRAMES)
    gen = torch.Generator(device).manual_seed(0)
    eps = torch.randn((nb, m["inter_channels"], frames), generator=gen,
                      device=device)[row:row + 1]
    x, xl = _pad([corpus.text_ids(r["text"], table, by_token)], device)
    o, y_len = vits.infer(p, m, x, xl, None, eps, frames)
    n = int(y_len[0])
    wave = torch.clamp(o[0, :n * module.hop_length], -1.0, 1.0)
    return n, np.round(wave.double().cpu().numpy() * PCM) / PCM


def gap_numbers(got: List[np.ndarray], ref: List[tuple], hop: int
               ) -> Dict[str, float]:
    """frames_off and pcm_gap of answers `got` against the reference's
    (frames, waveform) of the same requests: the share of answers whose
    frame count is not the reference's (the durations), and the worst
    relative L2 distance of the others (an empty sample reads inf in
    both)."""
    if not ref:
        return {"frames_off": math.inf, "pcm_gap": math.inf}
    off, gaps = 0, []
    for audio, (frames, wave) in zip(got, ref):
        if len(audio) // hop != frames:
            off += 1
            continue
        audio = np.asarray(audio, np.float64)
        gaps.append(float(np.linalg.norm(audio - wave)
                          / np.linalg.norm(wave)))
    return {"frames_off": off / len(ref),
            "pcm_gap": max(gaps) if gaps else math.inf}


def control_numbers(res, precision) -> Dict[str, float]:
    """The numbers of the reference computed under `precision` (a context
    manager) put in the program's place, on the run's sample."""
    check = res["check"]
    with torch.no_grad():
        with precision():
            low = [check["audio"](r) for r in check["picked"]]
        return gap_numbers([w for _, w in low], check["ref"], check["hop"])


def warm_signatures(module, table, frames, ids, max_batch: int) -> None:
    """Runs once every decode signature the traffic can reach: each text
    alone (the lone-request path), and for each batch bucket up to
    `max_batch` one batch for each (text bucket, frame bucket) that a
    batch's largest rows can give, its other rows the shortest text. The
    frame buckets come from the reference's predicted frames."""
    tb = [_next_bucket(len(i), module.TEXT_BUCKETS) for i in ids]
    fb = [min(_next_bucket(f, module.FRAME_BUCKETS), module.MAX_FRAMES)
          for f in frames]
    classes: Dict[tuple, int] = {}
    for i, key in enumerate(zip(tb, fb)):
        classes.setdefault(key, i)
    pairs: Dict[tuple, tuple] = {}
    for (t1, f1), a in classes.items():
        for (t2, f2), b in classes.items():
            pairs.setdefault((max(t1, t2), max(f1, f2)), (a, b))
    short = min(range(len(ids)), key=lambda i: (tb[i], fb[i]))
    for nb in sorted({_next_bucket(n, module.BATCH_BUCKETS, 8)
                      for n in range(2, max_batch + 1)}):
        for a, b in pairs.values():
            module.synthesize_batch([table[a], table[b]]
                                    + [table[short]] * (nb - 2), seed=0)
    for text in table:
        module.synthesize(text, seed=0)


def _row(r):
    """(the texts of the request's decode, its row), or None where its
    row is ambiguous (its text twice in one batch)."""
    t = r.get("timings") or {}
    if t.get("batched", 1) == 1:
        return [r["text"]], 0
    order = t["batch_order"]
    if order.count(r["text"]) != 1:
        return None
    return order, order.index(r["text"])


def _pad(id_rows, device):
    t = max(len(i) for i in id_rows)
    x = np.zeros((len(id_rows), t), np.int64)
    for k, ids in enumerate(id_rows):
        x[k, :len(ids)] = ids
    return (torch.from_numpy(x).to(device),
            torch.tensor([len(i) for i in id_rows], device=device))


def run(ctx) -> Dict:
    from mb_istft_vits_torch.config import Config
    from mb_istft_vits_torch.infer.synthesis import SynthesisModule
    from mb_istft_vits_torch.models import Synthesizer
    from mb_istft_vits_torch.serve.microbatch import MicroBatcher

    wl, conf, device = ctx.workload, ctx.config, ctx.device
    c = conf["corpus"]
    with open(f"{corpus.CORPUS}/{c['serve_texts']}.txt",
              encoding="utf-8") as f:
        table = [line.rstrip("\n") for line in f][:wl.get("texts")]
    cfg = Config.from_json(ctx.config_path)
    with torch.device("meta"):
        leaves = [(k, tuple(v.shape))
                  for k, v in Synthesizer(cfg.model).state_dict().items()]
    p = weights.make(leaves, wl["weights_seed"], device,
                     cfg.model.hidden_channels, wl.get("weight_overrides"))
    module = SynthesisModule(ctx.config_path, params=p, device=device)
    front = MicroBatcher(module, max_batch=wl["max_batch"],
                         max_wait_ms=wl["max_wait_ms"])
    front.start()
    load = Load(lambda text: front.synthesize(text), wl["workers"])
    rate = wl["rate_per_s"]
    ctx.log("module loaded")
    m = dict(conf["model"], n_vocab=cfg.model.n_vocab)
    symbols, by_token = corpus.symbols(c["module"]), c["module"] == "text_JP"
    ids = [corpus.text_ids(t, symbols, by_token) for t in table]
    try:
        with torch.no_grad():
            frames = [f for k in range(0, len(ids), 64)
                      for f in vits.predicted_frames(
                          p, m, *_pad(ids[k:k + 64], device), None).tolist()]
        warm_signatures(module, table, frames, ids, wl["max_batch"])
        ctx.log(f"signatures warm: {module.graphs.captures} captures")
        offsets, texts = schedule(rate, ctx.seconds, len(table))
        warm_offsets, warm_texts = schedule(rate, wl["warm_s"], len(table))
        warm = load.run(warm_offsets, warm_texts, table)
        failed_warm = sum(1 for r in warm if "answered" not in r)
        ctx.sync()
        ctx.log(f"warm: {len(warm)} requests, {failed_warm} unanswered, "
                f"{module.graphs.captures} captures")
        setup_s = time.time() - ctx.t_start
        captures = module.graphs.captures
        with ctx.tracer:
            with ctx.tracer.window():
                records = load.run(offsets, texts, table)
                ctx.sync()
            if ctx.tracer.enabled:
                with ctx.tracer.trailing():
                    front.synthesize(table[0])
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
        return reference_audio(r, module, p, m, symbols, by_token, device)

    picked = pick(records, wl["sample"], np.random.default_rng([ctx.seed, 2]))
    with torch.no_grad(), float32():
        ref = [audio(r) for r in picked]
    numbers = gap_numbers([r["audio"] for r in picked], ref,
                          module.hop_length)
    ctx.log("reference done")
    answered = [r for r in records if "timings" in r]
    decodes = sum(1.0 / r["timings"].get("batched", 1) for r in answered)
    dispatch = sorted({id(r["timings"]): r["timings"]["dispatch"] * 1e3
                       for r in answered
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
