"""The port's measurement tools on the CPU (`python -m
mb_istft_vits_torch.<tool>`, the JAX package's `bench.py` and
`scripts/bench_*.py`, `profile_*.py`, `flops_analysis.py`).

- Each tool's `main([..., "--device", "cpu"])` runs in process on the
  flagship config at the tiny width of torch_port_data.py (the train
  segment cut to 2048 samples), one repetition: its JSON line carries
  the JAX script's fields, `device.platform == "cpu"`, and every device
  field (the module's `DEVICE_FIELDS`) null. Without a card and without
  `--device cpu` each tool raises.
- Every option of the JAX script (read from its AST, so the JAX side is
  not imported) is accepted by the port tool's parser with the same
  default, unless `RULINGS` gives the reason it differs.
- The FLOP count of the flagship `infer` at 32 tokens and 128 frames is
  within 2 % of XLA's `cost_analysis` of the JAX program (at the tiny
  width XLA's element-wise count dominates, so this runs at the
  flagship's widths), and the byte counter of one conv1d is its input,
  weight, bias and output bytes.
- `bench`'s headline audio seconds and frame bucket equal the JAX
  `SynthesisModule`'s at the same weights; `bench_mas`'s problems are
  the JAX script's, and its plain route equals JAX's scan.
- The busy share of `utils.timing` (the union of device intervals) is
  at most 1 on overlapping intervals and on a Chrome trace; each
  profiled call's busy time is the union of its own intervals; every
  device timer gives no time on the CPU.
"""

from __future__ import annotations

import ast
import contextlib
import importlib
import io
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mb_istft_vits_torch.utils import timing
from tests.test_torch_port_serve import _fresh, pair  # noqa: F401
from torch_port_data import write_tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "ljs_mb_istft_vits.json")
# the port tool -> its JAX script
SCRIPTS = {
    "bench": "bench.py",
    "bench_train": "scripts/bench_train.py",
    "bench_batch": "scripts/bench_batch.py",
    "bench_stream": "scripts/bench_stream.py",
    "bench_chunk_decode": "scripts/bench_chunk_decode.py",
    "bench_microbatch": "scripts/bench_microbatch.py",
    "bench_export": "scripts/bench_export.py",
    "bench_mas": "scripts/bench_mas.py",
    "profile_step": "scripts/profile_step.py",
    "profile_infer": "scripts/profile_infer.py",
    "flops_analysis": "scripts/flops_analysis.py",
}
TRAIN_SHAPE = ["--batch", "2", "--spec-frames", "40", "--text-len", "16"]
# one repetition of each tool at the tiny width (--config added by the test)
ARGS = {
    "bench": ["--runs", "1"],
    "bench_train": [*TRAIN_SHAPE, "--steps", "1", "--flops", "--feed-host"],
    "bench_batch": ["--batch", "2", "--reps", "1"],
    "bench_stream": ["--reps", "1"],
    "bench_chunk_decode": ["--reps", "1"],
    "bench_microbatch": ["--clients", "2", "--rounds", "1", "--floor"],
    "bench_export": ["--reps", "1"],
    "bench_mas": ["--n", "1", "--reps", "1"],
    "profile_step": [*TRAIN_SHAPE, "--steps", "1"],
    "profile_infer": [],
    "flops_analysis": [*TRAIN_SHAPE, "--infer-frames", "64"],
}
# the quantities each JAX script prints, under the port's JSON names
FIELDS = {
    "bench": ["metric", "value", "unit", "vs_baseline", "device_iqr",
              "e2e_median", "e2e_iqr", "e2e_split_s.frontend",
              "e2e_split_s.dispatch", "e2e_split_s.sync", "audio_seconds",
              "runs.e2e", "runs.device", "frame_bucket"],
    "bench_train": ["first_step_s", "first_loss_g", "d_step_ms",
                    "step_ms_sync", "flops_per_step", "achieved_tflops",
                    "mfu", "peak_tflops", "step_ms_host_fed",
                    "feed_mb_per_step", "feed_gb_per_s",
                    "step_ms_double_buffered", "step_ms", "steps_per_s",
                    "audio_s_per_s", "batch", "spec_frames", "devices",
                    "all_finite"],
    "bench_batch": ["batch", "ms_per_batch", "utt_per_s", "audio_s_per_s",
                    "batch_rtf"],
    "bench_stream": [f"utterances.*.{p}.{k}" for p in ("fixed_64", "growing")
                     for k in ("ttfa_ms", "total_ms", "stream_rtf", "chunks")]
    + ["utterances.*.audio_s", "utterances.*.z_frames"],
    "bench_chunk_decode": ["latents", "audio_s"] + [
        f"strategies.{s}.{k}" for s in (
            "streaming_pipelined", "batched_one_dispatch",
            "spec_join_pipelined", "spec_join_batched", "full_decode")
        for k in ("ms", "rtf", "n")],
    "bench_microbatch": [
        "metric", "clients", "utterance_audio_s", "single_call_rtf_e2e",
        "microbatch_rtf_e2e", "speedup", "coalesced", "waves",
        "short_floor.audio_s", "short_floor.frame_bucket",
        "short_floor.probe_enc_dp_ms", "short_floor.latents_ms",
        "short_floor.align_flow_ms", "short_floor.decode_ms",
        "short_floor.full_infer_ms", "short_floor.rtf_device_full"],
    "bench_export": ["metric", "rtf_e2e_live", "rtf_e2e_exported",
                     "exported_over_live", "artifact_determinism_delta",
                     "live_vs_exported_delta", "export_s", "load_compile_s",
                     "audio_seconds", "artifact_dir"],
    "bench_mas": ["rows.*.shape", "rows.*.plain.kernel_ms"],
    "profile_step": ["trace", "by_category", "top_kernels", "device_ms"],
    "profile_infer": ["e2e", "tokens", "text_bucket", "frames",
                      "frame_bucket", "probe_ms", "infer_ms", "latents_ms",
                      "decode_ms", "host_copy_ms", "e2e_rtf",
                      "device_only_rtf", "stream.latents_ms",
                      "stream.first_audio_ms", "stream.chunks",
                      "stream.total_ms", "stream.audio_s",
                      "stream.stream_rtf"],
    "flops_analysis": [f"{p}.{k}" for p in ("d_step", "g_step",
                                             "train_step_total")
                       for k in ("gflop", "sol_ms", "gbytes", "bw_ms")]
    + ["infer.gflop", "infer.sol_ms", "infer.rtf_floor", "peak_tflops",
       "hbm_gbps"],
}
# JAX options the port does not take as they are, each with its reason
RULINGS = {
    ("flops_analysis", "--cpu"):
        "JAX lowers without running and defaults to the CPU; counting runs "
        "the program, so the port defaults to the card and --cpu asks for "
        "the CPU",
    ("flops_analysis", "--peak-tflops"):
        "197 is a TPU v5e's bf16 peak; the port's default is the H100's "
        "peak of the step's precision (utils.timing.peak_for)",
    ("flops_analysis", "--hbm-gbps"):
        "819 is a TPU v5e's HBM; the port's default is the H100's 3350",
    ("profile_step", "--logdir"):
        "/tmp/jaxprof: the port writes under the temp directory "
        "(tempfile.gettempdir()/torchprof)",
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads, as the suite's other port files: six workers of
    eight threads each stall on every small op."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tiny_config(tmp_path_factory):
    path = write_tiny_config(str(tmp_path_factory.mktemp("bench")))
    with open(path) as f:
        cfg = json.load(f)
    cfg["train"]["segment_size"] = 2048
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def run_tool(name, argv):
    """`main(argv)` of a port tool in process -> its JSON line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert importlib.import_module(
            f"mb_istft_vits_torch.{name}").main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _config_args(name, cfg):
    return [] if name == "bench_mas" else ["--config", cfg]


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_tool_runs_on_the_cpu_with_the_jax_fields(name, tiny_config,
                                                  tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = [*_config_args(name, tiny_config), *ARGS[name], "--device", "cpu"]
    if name == "profile_step":
        argv += ["--logdir", str(tmp_path / "prof")]
    out = run_tool(name, argv)
    for path in FIELDS[name]:
        assert timing.field_values(out, path), path
    assert out["device"] == {"platform": "cpu"}
    assert set(out["mas_launches"]) == {"mas_fused", "mas_fwd", "mas_bwd",
                                        "mas_path"}
    module = importlib.import_module(f"mb_istft_vits_torch.{name}")
    for path in module.DEVICE_FIELDS:
        values = timing.field_values(out, path)
        assert values and all(v is None for v in values), (path, values)


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_tool_needs_a_card_unless_asked_for_the_cpu(name, tiny_config,
                                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"mb_istft_vits_torch.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([*_config_args(name, tiny_config), *ARGS[name]])


def _jax_options(script):
    """{option: default} of every add_argument call in a JAX script."""
    with open(os.path.join(REPO, script), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    options = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            flag = node.args[0].value
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                default = ast.literal_eval(kw["default"])
            else:
                action = kw.get("action")
                default = (False if action is not None
                           and action.value == "store_true" else None)
            options[flag] = default
    return options


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_tool_takes_the_jax_script_s_options(name):
    parser = importlib.import_module(
        f"mb_istft_vits_torch.{name}").build_parser()
    actions = {s: a for a in parser._actions for s in a.option_strings}
    for flag, default in _jax_options(SCRIPTS[name]).items():
        assert flag in actions, f"{name} lacks {flag}"
        if (name, flag) not in RULINGS and flag != "--config":
            assert actions[flag].default == default, (name, flag)
    # --config: the JAX scripts name the flagship relative to the cwd
    if "--config" in actions:
        assert os.path.samefile(actions["--config"].default, CONFIG)
    for (tool, flag) in RULINGS:
        if tool == name:
            assert flag in _jax_options(SCRIPTS[name])


def test_infer_flops_match_xla_cost_analysis_at_flagship_width():
    """The port's FlopCounterMode count of the flagship `infer` (32 tokens,
    128 frames) within 2 % of XLA's cost analysis of the JAX program."""
    from mb_istft_vits_torch.config import Config as TorchConfig
    from mb_istft_vits_torch.models import Synthesizer as TorchSynthesizer
    from mb_istft_vits_tpu.config import Config as JaxConfig
    from mb_istft_vits_tpu.models import Synthesizer as JaxSynthesizer

    rng = np.random.RandomState(0)
    x = rng.randint(1, 100, (1, 32)).astype(np.int32)
    xl = np.array([32], np.int32)
    jcfg = JaxConfig.from_json(CONFIG).model
    model = JaxSynthesizer(jcfg)
    keys = {k: jax.random.PRNGKey(i) for i, k in
            enumerate(("params", "noise", "dropout", "slice"))}
    params = jax.eval_shape(lambda: model.init(
        keys, jnp.asarray(x), jnp.asarray(xl),
        jnp.zeros((1, 64, jcfg.spec_channels)), jnp.asarray([64], jnp.int32),
        train=False))["params"]

    def infer(params, x, xl):
        return model.apply({"params": params}, x, xl, max_frames=128,
                           method=JaxSynthesizer.infer,
                           rngs={"noise": jax.random.PRNGKey(0)}).o

    cost = jax.jit(infer).lower(params, jnp.asarray(x),
                                jnp.asarray(xl)).cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    torch.manual_seed(0)
    port = TorchSynthesizer(TorchConfig.from_json(CONFIG).model).eval()
    with torch.no_grad():
        counted = timing.count(lambda: port.infer(
            torch.from_numpy(x), torch.from_numpy(xl), max_frames=128,
            generator=torch.Generator().manual_seed(0)))
    ratio = counted["flops"] / cost["flops"]
    assert 0.98 <= ratio <= 1.02, (counted["flops"], cost["flops"])


def test_byte_counter_counts_one_conv1d_s_operands_and_result():
    conv = torch.nn.Conv1d(8, 16, 5)
    x = torch.randn(2, 8, 50)
    with torch.no_grad():
        counted = timing.count(lambda: conv(x))
    y = conv(x)
    assert counted["bytes"] == (x.nbytes + conv.weight.nbytes
                                + conv.bias.nbytes + y.nbytes)
    assert counted["flops"] == 2 * 2 * 16 * 46 * 8 * 5


def test_bench_headline_matches_the_jax_module(pair):  # noqa: F811
    """The headline sentence's audio seconds and frame bucket after the
    bench's three warm requests, on both packages at the same weights."""
    from mb_istft_vits_torch.bench import TEXT, headline

    ours, theirs = pair
    _fresh(ours, theirs)
    secs, bucket, _ = headline(ours)
    for _ in range(3):
        _, t = theirs.synthesize(TEXT, seed=0)
    assert (secs, bucket) == (t["audio_seconds"], t["frame_bucket"])


def test_bench_mas_problems_are_the_jax_script_s():
    """The JAX script's draws (scripts/bench_mas.py:51-58), in its order."""
    from mb_istft_vits_torch.bench_mas import SHAPES, problems

    rng = np.random.RandomState(0)
    for (b, t_y, t_x), (nc, mask) in zip(SHAPES, problems()):
        np.testing.assert_array_equal(
            nc, rng.randn(b, t_y, t_x).astype(np.float32))
        t_ys = rng.randint(t_y // 2, t_y + 1, b)
        t_xs = rng.randint(t_x // 2, t_x + 1, b)
        np.testing.assert_array_equal(mask.sum(axis=(1, 2)), t_ys * t_xs)
        np.testing.assert_array_equal(mask[:, :, 0].sum(1), t_ys)
        np.testing.assert_array_equal(mask[:, 0, :].sum(1), t_xs)


def test_bench_mas_plain_route_equals_jax_scan():
    from mb_istft_vits_torch.bench_mas import problems
    from mb_istft_vits_torch.ops import mas
    from mb_istft_vits_tpu.ops.mas import maximum_path

    for nc, mask in problems([(4, 40, 20), (3, 30, 12)]):
        ours = mas.maximum_path(torch.from_numpy(nc), torch.from_numpy(mask),
                                False).numpy()
        theirs = np.asarray(maximum_path(jnp.asarray(nc), jnp.asarray(mask),
                                         use_pallas=False))
        np.testing.assert_array_equal(ours, theirs)


def test_busy_share_is_the_union_of_overlapping_intervals():
    # stream 7: [0, 10) and [5, 15) overlap by 5; stream 8: [12, 20) by 3;
    # [30, 35) alone: union 25 of a sum 33
    act = timing.device_activity([(0, 10, 7, "a"), (5, 15, 7, "b"),
                                  (12, 20, 8, "c"), (30, 35, 7, "d")])
    assert act["device_ms"] * 1e3 == 33
    assert act["device_busy_ms"] * 1e3 == 25
    assert act["device_overlap_ms"] * 1e3 == 8
    assert act["device_same_stream_overlap_ms"] * 1e3 == 5
    fields = timing.busy_fields(act, wall_ms=0.035)
    assert fields["device_busy_share"] <= 1.0
    assert fields["device_busy_share"] == pytest.approx(25 / 35)
    assert fields["device_ms"] / 0.035 > 0.9  # the sum's share: 33 / 35


def test_each_call_s_busy_time_is_the_union_of_its_own_intervals():
    # calls start at 0, 9 and 25 us; [12, 18) on another stream overlaps
    # [10, 14) by 2; [31, 32) lies inside [30, 33)
    intervals = [(0, 4, 7, "w"), (10, 14, 7, "a"), (12, 18, 8, "b"),
                 (30, 33, 7, "c"), (31, 32, 7, "d")]
    assert [round(ms * 1e3, 9) for ms in timing.calls_busy_ms(
        intervals, [0, 9, 25])] == [4, 8, 3]


@pytest.mark.parametrize("timer", ["busy_ms", "busy_median_ms", "card_ms",
                                   "busy"])
def test_device_timer_runs_the_call_once_and_gives_no_time_on_the_cpu(
        timer):
    calls = []
    out = getattr(timing, timer)(lambda: calls.append(1), "cpu")
    assert calls == [1]
    if timer == "busy":
        assert out and all(v is None for v in out.values())
    else:
        assert out is None


def test_busy_share_of_a_chrome_trace(tmp_path):
    """Two streams' kernels overlapping inside a 100 us window read as
    the union; host events and device events outside the three device
    categories are not device time."""
    from mb_istft_vits_torch.profile_step import newest_trace, parse_trace

    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv1d", "ts": 1000,
         "dur": 100, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_dgrad_x",
         "ts": 1010, "dur": 60, "args": {"stream": 7}},
        {"ph": "X", "cat": "kernel", "name": "ampere_sgemm_64x64",
         "ts": 1040, "dur": 50, "args": {"stream": 20}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 1092, "dur": 4, "args": {"stream": 20}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1005, "dur": 3, "tid": 1},
    ]
    (tmp_path / "host_1.pt.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    report = parse_trace(newest_trace(str(tmp_path)))
    assert run_tool("profile_step", ["--parse-only", str(tmp_path)]) == {
        "metric": "profile_trace", **report, "device": None}
    assert report["window_ms"] * 1e3 == 100
    assert report["device_ms"] * 1e3 == pytest.approx(114)
    assert report["device_busy_ms"] * 1e3 == pytest.approx(84)
    assert report["device_overlap_ms"] * 1e3 == pytest.approx(30)
    assert report["device_busy_share"] == pytest.approx(0.84)
    assert {c["name"] for c in report["by_category"]} == {
        "conv dgrad", "gemm", "copy/memset"}


def test_a_chrome_trace_is_cut_at_its_trailing_range(tmp_path):
    """A kernel that starts after the trace's first trailing range
    (`timing.run_trailing`) is neither device time nor window, one before
    it is."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv1d", "ts": 1000,
         "dur": 100, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_dgrad_x",
         "ts": 1010, "dur": 60, "args": {"stream": 7}},
        {"ph": "X", "cat": "user_annotation", "name": timing.TRAILING_MARK,
         "ts": 1200, "dur": 400, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_dgrad_x",
         "ts": 1250, "dur": 60, "args": {"stream": 7}},
    ]
    path = tmp_path / "host_1.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    device, window_us = timing.trace_device_events(str(path))
    assert [e["ts"] for e in device] == [1010.0]
    assert window_us == 100


def test_profile_call_leaves_out_its_trailing_calls():
    """`profile_call(fn, trailing=g)` runs g TRAILING_CALLS times after
    fn, in the trailing range, and reads no event of it: on the CPU, g's
    ops are absent from the host rows, fn's are there."""
    calls = []

    def trailing():
        calls.append(1)
        torch.zeros(5).add_(1.0)

    prof = timing.profile_call(lambda: torch.ones(3).mul_(2.0),
                               trailing=trailing)
    names = {row["name"] for row in prof["top_host"]}
    assert len(calls) == timing.TRAILING_CALLS == 2
    assert "aten::mul_" in names
    assert not names & {"aten::add_", "aten::zeros", timing.TRAILING_MARK}
    assert prof["mas_kernels"] == {} and prof["mas_device_ms"] == 0


def test_before_trailing_keeps_the_events_that_start_before_it():
    from types import SimpleNamespace

    def event(name, start):
        return SimpleNamespace(name=name,
                               time_range=SimpleNamespace(start=start))

    events = [event("a", 0), event(timing.TRAILING_MARK, 10),
              event("b", 5), event("c", 12), event(timing.TRAILING_MARK, 20)]
    assert [e.name for e in timing.before_trailing(events)] == ["a", "b"]
    assert timing.before_trailing(events[:1]) == events[:1]


@pytest.mark.parametrize("groups", [1, 4, 256])
def test_a_conv_gradient_costs_its_forward_s_flops(groups):
    """torch's own formula counts a grouped conv's weight gradient
    `groups` times over; the port's count (DiscriminatorS has groups up
    to 256) takes each gradient at the forward's FLOPs, as XLA does."""
    conv = torch.nn.Conv1d(256, 256, 41, 4, groups=groups, padding=20)
    x = torch.randn(2, 256, 128)
    forward = timing.count(lambda: conv(x))["flops"]
    weight_only = conv(x)
    both = conv(x.clone().requires_grad_(True))
    assert timing.count(
        lambda: weight_only.sum().backward())["flops"] == forward
    assert timing.count(lambda: both.sum().backward())["flops"] == 2 * forward


@pytest.mark.parametrize("dtype, tf32, name, peak", [
    (torch.float32, False, "float32", 67e12),
    (torch.float32, True, "tf32", 495e12),
    (torch.bfloat16, False, "bfloat16", 989e12),
    (torch.float16, True, "float16", 989e12),
])
def test_peak_for_the_step_s_precision(dtype, tf32, name, peak):
    assert timing.peak_for(dtype, tf32) == (name, peak)
