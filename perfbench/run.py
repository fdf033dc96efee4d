#!/usr/bin/env python3
"""Runs one benchmark cell of `BENCHMARK.json` once and prints one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration (`perfbench/configs/<config>.json`) and has
a file of its own (`perfbench/workloads/<cell>.json`) that names its
driver (`perfbench/drivers/<driver>.py`), its traffic parameters and the
limits of its correctness numbers. Per-layer metrics are readers,
`perfbench/metrics/<metric>.py`, each with a `read(ctx, result, trace)`
that returns a number or None. Nothing here is edited to add a cell, a
configuration or a metric: the harness finds each by its name.

The run sets up, measures for `--seconds`, checks the answers against the
plain reference in `perfbench/reference` and prints the result: with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics from a profiled window. It exits non-zero with no result when
there is no CUDA device (or fewer than the cell asks for), or when the
JAX package or JAX itself was loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# build and kernel caches inside the checkout, at fixed paths
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, os.path.join(HERE, ".cache", _dir))

import torch  # noqa: E402

from perfbench.yardstick import compare  # noqa: E402
from perfbench.yardstick.trace import Tracer  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mb_istft_vits_tpu")


class Refused(Exception):
    """A run that must print no result."""


@dataclass
class Context:
    """What a driver gets: the cell's entries and files, the run's
    arguments, the device and the tracer."""

    bench: Dict
    cell: Dict
    config: Dict
    config_path: str
    workload: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float = T_START
    tracer: Tracer = field(init=False)

    def __post_init__(self):
        self.tracer = Tracer(self.trace)

    def log(self, msg: str) -> None:
        """A progress line on standard error, seconds since the start."""
        print(f"perfbench: {time.time() - self.t_start:8.2f} s {msg}",
              file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def event(self):
        """A marker of the work queued so far: `.synchronize()` waits for
        it."""
        if self.device.type != "cuda":
            return _Done()
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def precision(self) -> str:
        """The precision the step runs in, read from the process: bf16
        autocast (`fp16_run`), else TF32 if either switch is on, else
        float32."""
        if self.config["train"].get("fp16_run"):
            return "bfloat16"
        if self.device.type == "cuda" and (
                torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32):
            return "tf32"
        return "float32"

    def check_modules(self) -> None:
        loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                        & set(FORBIDDEN))
        if loaded:
            raise Refused("modules that must not load were loaded: "
                          + ", ".join(loaded))


class _Done:
    def synchronize(self) -> None:
        pass


def load_file(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}",
        os.path.join(HERE, "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: Dict, cell: str):
    """(end-to-end, per-layer) metric entries this cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def context(cell_name: str, seed: int, seconds: float, trace: bool,
            device: torch.device, bench: Optional[Dict] = None,
            config_path: Optional[str] = None,
            workload: Optional[Dict] = None) -> Context:
    """The run's context; a test may pass its own benchmark, config file
    and workload."""
    bench = bench or load_file(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == cell["config"])
    config_path = config_path or os.path.join(ROOT, conf_entry["file"])
    workload = workload or load_file(
        os.path.join(HERE, "workloads", f"{cell_name}.json"))
    return Context(bench, cell, load_file(config_path), config_path,
                   workload, seed, seconds, trace, device)


def execute(ctx: Context) -> Dict[str, Any]:
    """Set-up, the window and the check, through the cell's driver; the
    result's line as a dict."""
    driver = importlib.import_module(
        f"perfbench.drivers.{ctx.workload['driver']}")
    res = driver.run(ctx)
    checks = compare.checks(res["numbers"], ctx.workload["limits"])
    e2e, layer = cell_metrics(ctx.bench, ctx.cell["name"])
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(ctx.device)
                       if ctx.device.type == "cuda" else "cpu"),
              "count": ctx.cell["chips"],
              "memory_peak_bytes": res["memory_peak"]}
    out: Dict[str, Any] = {
        "correct": compare.passed(checks),
        "attempted": res["attempted"], "failed": res["failed"]}
    if ctx.trace:
        data = ctx.tracer.data
        metrics = {}
        for m in layer:
            value = reader(m["name"])(ctx, res, data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["metrics"] = metrics
        device.update(busy_s=data.busy_s(), window_s=data.window_s)
        out["device"] = device
        out["breakdown"] = {"device_ops": data.top_device_ops(),
                            "idle_gaps": data.idle_gaps()}
    else:
        out["metrics"] = {m["name"]: {"value": res["end_to_end"][m["name"]],
                                      "unit": m["unit"]} for m in e2e}
        out["device"] = device
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    ctx = context(args.workload, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0))
    chips = ctx.cell["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); {have} "
              "available", file=sys.stderr)
        return 2
    try:
        out = execute(ctx)
        ctx.check_modules()
    except Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
