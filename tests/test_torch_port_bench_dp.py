"""The data-parallel benchmark cell and the counts the new per-layer
metrics read (port only, no JAX).

`perfbench/drivers/train_dp.py` run as two gloo ranks on the CPU at a
small size: the port's reduced gradients, losses and changes agree with
`perfbench/reference/train_dp.py` (every rank's chunk under its own
dropout seed, the KL and duration terms at the global mask sums, the
gradient summed over the ranks), and a rank whose gradients skip the
all-reduce fails `grad_gap`. `train.step.drive` records each collective
as a `train.collective` span only while a profiler runs. The count log
of `utils.observability` records only while a profiler runs and counts
its drops. `dp_collective_exposed_ms`, `serve_frame_pad_share` and
`serve_mfu` read planted spans and counts over a planted trace as
computed by hand, and nothing without them."""

from __future__ import annotations

import json
import os

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from mb_istft_vits_torch.utils import observability as obs
from perfbench.yardstick import flops, flops_serve
from perfbench.yardstick.stats import PEAK_OPS_PER_S
from perfbench.yardstick.trace import TraceData

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2_147_483_659  # past 32 signed bits, as a benchmark run's seed may be


@pytest.fixture(scope="module")
def harness():
    """`perfbench/run.py` (the environment its import sets is put
    back)."""
    saved = dict(os.environ)
    try:
        from perfbench import run
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return run


def _tiny(tmp_path, name):
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        conf = json.load(f)
    conf["model"].update(hidden_channels=32, filter_channels=64,
                         inter_channels=32, upsample_initial_channel=32,
                         n_layers=2)
    if conf["model"].get("gin_channels"):
        conf["model"]["gin_channels"] = 16
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    return path


def _dp_run(harness, tmp_path, config, monkeypatch):
    """The dp4 cell's driver as two gloo ranks at a small size; the
    flagship's config puts two buckets in the cycle, so the replay of a
    second signature is checked too. The test process holds JAX (the
    suite's conftest loads it), so the harness's check that the run
    loaded none is left to the benchmark's own processes."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setattr(harness.Context, "check_modules", lambda self: None)
    with open(os.path.join(ROOT, "perfbench", "workloads",
                           "uudb_ms.train_dp4.json")) as f:
        own = json.load(f)
    if config == "ljs_mb":
        own["weight_overrides"] = {"g.dp.proj.bias": 0.83}
    workload = dict(own, batch=2, cycle_steps=2, buckets=[0, 1], world=2)
    ctx = harness.context("uudb_ms.train_dp4", SEED, 0.5, False,
                          torch.device("cpu"),
                          config_path=_tiny(tmp_path, config),
                          workload=workload)
    return harness.execute(ctx)


@pytest.mark.parametrize("config", ["uudb_ms", "ljs_mb"])
def test_two_gloo_ranks_agree_with_the_data_parallel_reference(
        harness, tmp_path, config, monkeypatch):
    out = _dp_run(harness, tmp_path, config, monkeypatch)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["device"]["count"] == 4  # the cell's chips, as declared
    assert set(out["metrics"]) == {"train_audio_s_per_s", "setup_s"}
    if config == "ljs_mb":
        assert out["checks"]["replay_loss_gap"]["value"] > 0


def test_a_rank_whose_gradients_skip_the_all_reduce_fails_grad_gap(
        harness, tmp_path, monkeypatch):
    """Rank 0 (this process) reduces a copy of its buffers: the
    collectives still meet, and its optimizer takes its own gradients."""
    from mb_istft_vits_torch.train import step

    def skipped(state, i):
        torch.distributed.all_reduce(
            state.grad_buffers[step.REDUCED[i]].clone(), group=state.group)

    monkeypatch.setattr(step, "all_reduce_buffer", skipped)
    out = _dp_run(harness, tmp_path, "uudb_ms", monkeypatch)
    assert not out["correct"], out["checks"]
    grad = out["checks"]["grad_gap"]
    assert grad["value"] > 10 * grad["limit"], out["checks"]


# -- spans and counts ---------------------------------------------------------

@pytest.fixture
def logs(monkeypatch):
    spans, counts = obs.SpanLog(), obs.SpanLog()
    monkeypatch.setattr(obs, "SPANS", spans)
    monkeypatch.setattr(obs, "COUNTS", counts)
    return spans, counts


def test_drive_records_each_collective_only_while_profiling(logs,
                                                            monkeypatch):
    from mb_istft_vits_torch.train import step

    ran = []
    monkeypatch.setattr(step, "collectives", lambda state: [
        lambda: ran.append("a"), lambda: ran.append("b")])
    step.drive(None, lambda i: ran.append(i), 3)
    assert ran == [0, "a", 1, "b", 2] and logs[0].spans(0, 1 << 62)[0] == []
    with profile(activities=[ProfilerActivity.CPU]):
        step.drive(None, lambda i: None, 3)
    got = logs[0].spans(0, 1 << 62)[0]
    assert [n for n, *_ in got] == ["train.collective"] * 2
    assert all(s <= e for _, _, s, e in got)


def test_the_count_log_records_only_while_profiling_and_counts_drops(
        logs, monkeypatch):
    assert not autograd_profiler._is_profiler_enabled
    assert not obs.recording()
    obs.record_count("synth.frames", (1, 128, (100,), (40,)))
    assert obs.recorded_counts(0, 1 << 62) == ([], 0)
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.recording()
        obs.record_count("synth.frames", (1, 128, (100,), (40,)))
    got, dropped = obs.recorded_counts(0, 1 << 62)
    assert dropped == 0 and [v for _, _, v in got] == [(1, 128, (100,),
                                                        (40,))]
    small = obs.SpanLog(maxlen=2)
    monkeypatch.setattr(obs, "COUNTS", small)
    for t in range(5):
        small.record("c", 10 * t, 10 * t, (t,))
    assert small.dropped == 3
    assert obs.recorded_counts(0, 100) == ([("c", 30, (3,)),
                                            ("c", 40, (4,))], 3)
    assert obs.recorded_counts(25, 100)[1] == 0  # the drops all before 25


MS = 1_000_000  # ns


def _trace(device, host=()):
    return TraceData(0, 100 * MS, device=sorted(device), host=list(host))


def test_dp_collective_exposed_ms_reads_the_planted_trace(harness, logs):
    read = harness.reader("dp_collective_exposed_ms")
    # two steps of two collectives; the second step's first all-reduce is
    # half overlapped by another kernel
    device = [(0, 10 * MS, "fwd"), (10 * MS, 12 * MS, "ncclAllReduce"),
              (12 * MS, 30 * MS, "g"), (30 * MS, 31 * MS, "ncclAllReduce"),
              (40 * MS, 50 * MS, "fwd"), (49 * MS, 53 * MS, "ncclAllReduce"),
              (53 * MS, 60 * MS, "g"), (60 * MS, 63 * MS, "ncclAllReduce")]
    for s in (10, 30, 49, 60):
        logs[0].record("train.collective", s * MS, s * MS + 100)
    got = read(None, {"counters": {"steps": 2}}, _trace(device))
    # step 1: 2 + 1 ms exposed; step 2: 3 + 3 ms
    assert got == pytest.approx((3.0 + 6.0) / 2)
    assert read(None, {"counters": {"steps": 2}}, None) is None


def test_dp_collective_exposed_ms_reads_nothing_without_spans(harness, logs):
    read = harness.reader("dp_collective_exposed_ms")
    device = [(10 * MS, 12 * MS, "ncclAllReduce")]
    assert read(None, {"counters": {"steps": 1}}, _trace(device)) is None


PLANTED = [(2, 256, (200, 150), (70, 50)), (1, 128, (100,), (40,))]


def test_serve_frame_pad_share_reads_the_planted_counts(harness, logs):
    read = harness.reader("serve_frame_pad_share")
    for v in PLANTED:
        logs[1].record("synth.frames", 5 * MS, 5 * MS, v)
    logs[1].record("synth.frames", 200 * MS, 200 * MS, (8, 1024, (1,), (1,)))
    got = read(None, {}, _trace([]))
    assert got == pytest.approx(100.0 * (640 - 450) / 640)
    assert read(None, {}, None) is None


def test_serve_mfu_reads_the_planted_counts(harness, logs):
    read = harness.reader("serve_mfu")
    for v in PLANTED:
        logs[1].record("synth.frames", 5 * MS, 5 * MS, v)

    class Ctx:
        with open(os.path.join(ROOT, "perfbench", "configs",
                               "vits_vctk.json")) as f:
            config = json.load(f)

    want = sum(flops_serve.request_flops(Ctx.config, x, y)
               for x, y in ((70, 200), (50, 150), (40, 100)))
    got = read(Ctx, {}, _trace([]))
    assert got == pytest.approx(100.0 * want / (0.1 * PEAK_OPS_PER_S[
        "float32"]))


@pytest.mark.parametrize("name", ["serve_frame_pad_share", "serve_mfu"])
def test_serving_count_readers_read_nothing_without_counts(harness, logs,
                                                           name,
                                                           monkeypatch):
    read = harness.reader(name)
    assert read(None, {}, _trace([])) is None
    logs[1].record("synth.frames", 5 * MS, 5 * MS, PLANTED[0])
    monkeypatch.setattr(logs[1], "dropped", 1)
    monkeypatch.setattr(logs[1], "_dropped_end_ns", 50 * MS)
    assert read(None, {}, _trace([])) is None


def test_the_vits_head_costs_what_its_layers_say():
    """`flops_serve` of VITS's HiFi-GAN head a frame: the trunk as
    `flops.decoder` counts it, the speaker's conv once, the post conv at
    256 samples a frame; about 4.3 times the flagship's MB head."""
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "vits_vctk.json")) as f:
        vits = json.load(f)
    with open(os.path.join(ROOT, "perfbench", "configs", "ljs_mb.json")) as f:
        ljs = json.load(f)
    head = flops_serve.head(vits["model"], vits["data"], 100) / 100
    assert head == pytest.approx(0.6152e9, rel=1e-3)
    cond, post = 2.0 * 512 * 256, 2.0 * 32 * 7 * 256
    trunk = flops.decoder(dict(vits["model"], subbands=0, gen_istft_n_fft=0,
                               gin_channels=0), 100)[0]
    assert head * 100 == pytest.approx(trunk + cond + 100 * post)
    ratio = head / (flops_serve.head(ljs["model"], ljs["data"], 100) / 100)
    assert 4.0 < ratio < 4.6
