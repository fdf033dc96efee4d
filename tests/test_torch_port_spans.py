"""The span recorder of `mb_istft_vits_torch.utils.observability` and the
benchmark metrics that read it (port only, no JAX).

Off (no profiler), `span` is one shared null context and nothing is
recorded. On, spans from every thread land in one bounded log, on the
clock of the profiler's host events: a span opened around a
`record_function` block brackets that range's own stamps. A full log
counts its drops, and a metric then reports nothing. The six serving
metrics of `perfbench/metrics/` read planted spans over a planted trace
as computed by hand, and nothing without spans or without the recorder.
`profile_trace` writes the spans into its Chrome trace on the trace's
own time base, on rows of their own.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import threading
import time
import tracemalloc

import pytest
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

from mb_istft_vits_torch.utils import observability as obs
from perfbench.yardstick.trace import TraceData

MS = 1_000_000  # ns


@pytest.fixture
def log(monkeypatch):
    """A fresh process-wide span log for the test."""
    fresh = obs.SpanLog()
    monkeypatch.setattr(obs, "SPANS", fresh)
    return fresh


def _all(log):
    return log.spans(0, 1 << 62)[0]


def test_off_span_is_one_null_context_and_records_nothing(log):
    assert not autograd_profiler._is_profiler_enabled
    assert obs.span("a") is obs.span("b")
    with obs.span("a") as start:
        assert start is None
    obs.record_span("b", 1, 2)
    assert _all(log) == [] and log.dropped == 0
    # the off path allocates nothing in the recorder's code: a thousand
    # spans kept alive hold no memory of its own
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        kept = []
        for _ in range(1000):
            with obs.span("a") as start:
                kept.append((obs.span("b"), start))
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, obs.__file__)]
    grew = after.filter_traces(mine).compare_to(
        before.filter_traces(mine), "lineno")
    assert sum(d.size_diff for d in grew) <= 0, grew


def test_on_records_every_thread_on_the_profilers_clock(log):
    go, done = threading.Event(), threading.Event()

    def worker():  # a thread started before the profiler
        go.wait(10)
        with obs.span("t.worker"):
            time.sleep(0.001)
        done.set()

    th = threading.Thread(target=worker)
    th.start()
    reps = 5
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        go.set()
        assert done.wait(10)
        with record_function("t.warm"):
            pass
        for k in range(reps):
            with obs.span(f"t.main{k}") as start:
                assert isinstance(start, int)
                with record_function(f"t.range{k}"):
                    time.sleep(0.005)
    th.join(10)
    assert not th.is_alive()
    spans = {name: (tid, s, e) for name, tid, s, e in _all(log)}
    assert set(spans) == {"t.worker"} | {f"t.main{k}" for k in range(reps)}
    assert spans["t.worker"][0] == th.native_id
    assert spans["t.main0"][0] == threading.get_native_id()
    ranges = {ev.name(): ev for ev in prof.profiler.kineto_results.events()}
    # each span brackets its range (up to the profiler's clock
    # conversion), and the closest of them within 1 ms at both ends: a
    # busy host can delay one range's stamp past its span's
    slack = MS // 20
    leads, lags = [], []
    for k in range(reps):
        _, s, e = spans[f"t.main{k}"]
        rng = ranges[f"t.range{k}"]
        leads.append(rng.start_ns() - s)
        lags.append(e - rng.end_ns())
    assert min(leads) >= -slack and min(lags) >= -slack, (leads, lags)
    assert min(leads) <= MS and min(lags) <= MS, (leads, lags)


def test_a_full_log_counts_its_drops():
    log = obs.SpanLog(maxlen=4)
    for k in range(6):
        log.record("x", 10 * k, 10 * k + 5)
    assert log.dropped == 2
    spans, dropped = log.spans(0, 100)
    assert [s[2] for s in spans] == [20, 30, 40, 50] and dropped == 2
    # drops that all ended before the window leave it whole
    assert log.spans(20, 100) == (spans, 0)


def test_a_full_log_loses_no_count_under_many_threads():
    """More writers than cores, the interpreter switching every
    microsecond: every span is either kept or counted as dropped."""
    log = obs.SpanLog(maxlen=64)
    n_threads, each = 4 * (os.cpu_count() or 4), 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [log.record("x", k, k + 1) for k in range(each)])
            for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    spans, dropped = log.spans(0, each)
    assert len(spans) == 64
    assert len(spans) + dropped == n_threads * each


# -- the benchmark's readers --------------------------------------------------

READERS = ["serve_queue_ms", "device_idle.serve_coalesce",
           "device_idle.serve_decode", "serve_probe_ms",
           "serve_dispatch_all_ms", "serve_retry_share"]

# a 1,000 ns window: the device busy over [100, 300) and [600, 700)
TRACE = TraceData(0, 1000, device=[(100, 200, "k"), (150, 300, "k"),
                                   (600, 700, "k"), (1200, 1300, "k")])
PLANTED = [
    ("serve.decode", -100, 50),  # starts before the window: left out
    ("serve.queued", 10, 120), ("serve.queued", 20, 120),
    ("serve.queued", 30, 950),
    ("serve.coalesce", 50, 120), ("serve.coalesce", 900, 950),
    ("serve.decode", 120, 650), ("serve.decode", 950, 1100),
    ("synth.probe", 130, 200), ("synth.probe", 960, 990),
    ("synth.dispatch", 200, 250), ("synth.dispatch", 300, 330),
    ("synth.dispatch", 990, 995),
    ("synth.retry", 400, 600),
    ("serve.decode", 1000, 1100),  # starts after the window: left out
]
EXPECTED = {
    "serve_queue_ms": 110 / MS,  # of 110, 100, 920 ns
    # idle in [50, 100) and [900, 950): 100 ns of 1,000
    "device_idle.serve_coalesce": 10.0,
    # [120, 650): 530 - 180 - 50 busy; [950, 1000): 50 idle
    "device_idle.serve_decode": 35.0,
    "serve_probe_ms": 50 / MS,  # of 70, 30 ns
    "serve_dispatch_all_ms": 30 / MS,  # of 50, 30, 5 ns
    "serve_retry_share": 50.0,  # 1 retry, 2 decodes
}


@pytest.fixture(scope="module")
def reader():
    """`perfbench/run.py`'s loader of a metric's reader (the environment
    its import sets is put back)."""
    saved = dict(os.environ)
    try:
        from perfbench import run
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return run.reader


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_planted_spans(name, reader, log):
    for span_name, s, e in PLANTED:
        log.record(span_name, s, e)
    assert reader(name)(None, {}, TRACE) == pytest.approx(EXPECTED[name])
    assert reader(name)(None, {}, None) is None  # an untraced run


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_spans(name, reader, log):
    assert reader(name)(None, {}, TRACE) is None
    log.record("synth.dispatch", 990, 995)
    with pytest.MonkeyPatch.context() as mp:  # a log that dropped spans
        mp.setattr(log, "dropped", 1)
        mp.setattr(log, "_dropped_end_ns", 500)
        assert reader(name)(None, {}, TRACE) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_from_a_program_without_the_recorder(
        name, reader, log, monkeypatch):
    for span_name, s, e in PLANTED:
        log.record(span_name, s, e)
    monkeypatch.setitem(sys.modules,
                        "mb_istft_vits_torch.utils.observability", None)
    assert reader(name)(None, {}, TRACE) is None


def test_idle_shares_add_up_to_no_more_than_the_device_idle_share(
        reader, log):
    for span_name, s, e in PLANTED:
        log.record(span_name, s, e)
    parts = sum(reader(name)(None, {}, TRACE) for name in
                ("device_idle.serve_coalesce", "device_idle.serve_decode"))
    assert parts <= reader("device_idle.serve")(None, {}, TRACE)


# -- profile_trace's Chrome trace ---------------------------------------------


def _trace_events(log_dir):
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_profile_trace_holds_the_spans_on_its_time_base(tmp_path, log):
    with obs.profile_trace(str(tmp_path)):
        with record_function("t.outer"):
            time.sleep(0.002)
            with obs.span("t.inner"):
                time.sleep(0.002)
            time.sleep(0.002)
    events = _trace_events(str(tmp_path))
    outer = next(e for e in events if e.get("name") == "t.outer")
    inner = next(e for e in events if e.get("name") == "t.inner")
    assert inner["ph"] == "X" and inner["cat"] == "span"
    assert outer["ts"] < inner["ts"]
    assert inner["ts"] + inner["dur"] < outer["ts"] + outer["dur"]
    assert inner["tid"] not in {e.get("tid") for e in events
                                if e.get("cat") != "span"
                                and e.get("ph") == "X"}


def test_profile_trace_lays_overlapping_spans_on_rows_that_nest(
        tmp_path, log):
    with obs.profile_trace(str(tmp_path)):
        time.sleep(0.01)
        t = obs.now_ns() - 9 * MS
        # the queue waits one thread records for its callers overlap
        for k in range(3):
            obs.record_span("t.queued", t + k * MS, t + (3 + k) * MS)
        obs.record_span("t.decode", t + 3 * MS, t + 9 * MS)
        obs.record_span("t.probe", t + 4 * MS, t + 5 * MS)
    events = [e for e in _trace_events(str(tmp_path))
              if e.get("cat") == "span"]
    assert len(events) == 5
    rows = {}
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        rows.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"]))
    assert len(rows) == 3
    for spans in rows.values():  # on each row, any two nest or are apart
        for i, (s1, e1) in enumerate(spans):
            for s2, e2 in spans[i + 1:]:
                assert e1 <= s2 or e2 <= e1
