"""What the measurement tools share: the card's record, its published
peaks, CUDA-event timers, a profiled call's device busy time, and FLOP and
byte counts of a call.

Device times come from CUDA events or from torch.profiler only. On the
CPU the timers run the call once and return None: a tool then writes
null, never a host time under a device name. A tool that finds no card
without `--device cpu` raises (`tool_device`).
"""

from __future__ import annotations

import collections
import json
import re
import statistics
import subprocess
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from mb_istft_vits_torch.device import disable_tf32, resolve_device

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at its 700 W
# limit): operations a second by the precision a program computes in, and
# HBM bytes a second.
PEAK_OPS_PER_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
                  "float16": 989e12}
HBM_BYTES_PER_S = 3.35e12
REPS = 10
# device events of a Chrome trace: kernels, copies, memsets
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def peak_for(dtype: torch.dtype, tf32: bool = False) -> Tuple[str, float]:
    """(precision, peak operations a second) of a program that computes in
    `dtype` (its autocast dtype, else its weights'); float32 matmuls and
    convolutions run on the tensor cores' TF32 path when `tf32`."""
    if dtype in (torch.bfloat16, torch.float16):
        name = str(dtype).split(".")[-1]
    elif dtype == torch.float32:
        name = "tf32" if tf32 else "float32"
    else:
        raise ValueError(f"no published peak for {dtype}")
    return name, PEAK_OPS_PER_S[name]


def tf32_enabled() -> bool:
    """Whether float32 convolutions or matmuls may take the TF32 path."""
    return (torch.backends.cudnn.allow_tf32
            or torch.backends.cuda.matmul.allow_tf32)


def nvidia_smi(index: int = 0) -> str:
    """The card's `name, power.limit` as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def device_record(device) -> dict:
    """Where a tool ran: {"platform": "cpu"}, or the card's name, the
    count of cards and its power limit (nvidia-smi)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu"}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = nvidia_smi(index)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(index),
            "count": torch.cuda.device_count(),
            "power_limit": smi.rpartition(",")[2].strip(), "nvidia_smi": smi}


def add_device_argument(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="cuda (the default; no card is an error) or cpu "
                             "(counts only: every device time is null)")


def tool_device(name: Optional[str]) -> torch.device:
    """The device a tool measures: CUDA unless `name` says otherwise (no
    card raises), float32 kept out of TF32 on the card."""
    dev = resolve_device(name)
    if dev.type == "cuda":
        disable_tf32()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def emit(record: dict, device) -> None:
    """Print a tool's one JSON line: `record`, the device's record and the
    MAS kernels' launches in this process."""
    from mb_istft_vits_torch.ops import mas

    print(json.dumps({**record, "device": device_record(device),
                      "mas_launches": dict(mas.launch_counts)}), flush=True)


def field_values(record, path: str) -> list:
    """The values at a dotted `path` of a tool's record; "*" takes every
    key of a dict or item of a list. A missing key raises KeyError."""
    nodes = [record]
    for key in path.split("."):
        if key == "*":
            nodes = [v for n in nodes
                     for v in (n.values() if isinstance(n, dict) else n)]
        else:
            nodes = [n[key] for n in nodes]
    return nodes


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """Median CUDA-event time of one call, after warm-up."""
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
    """Device time of one call of fn, the host's work left out where the
    card is the slower: the stream first sleeps, so the host queues calls
    before the first one runs, and the card runs the `reps` calls back to
    back; CUDA events time the burst. Median over `bursts`. Where the host
    queues a call slower than the card runs it, the burst reads the host's
    rate: `busy_median_ms` then reads the card's own time."""
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


def card_ms(fn, device, reps: int = REPS, bursts: int = 3
            ) -> Optional[float]:
    """`kernel_time_ms` of fn on a card; on the CPU fn runs once and the
    result is None (no device time)."""
    if torch.device(device).type != "cuda":
        fn()
        return None
    return kernel_time_ms(fn, reps, bursts)


# ---------------------------------------------------------------------------
# device activity: busy time as the union of intervals
# ---------------------------------------------------------------------------


def device_activity(intervals: Iterable[Tuple[float, float, object, str]]
                    ) -> dict:
    """Device time of activity intervals (start_us, end_us, stream, name):
    `device_ms` the sum of their durations, `device_busy_ms` the length of
    their union (at most the window they lie in), `device_overlap_ms` the
    difference. In start order each interval's overlap is the part of it
    that earlier ones already cover; `device_same_stream_overlap_ms` is
    the part covered by an interval of its own stream, and `overlap_top`
    the (stream, name) pairs with the most overlap."""
    total = busy = same = 0.0
    cover_end, cover_stream = float("-inf"), None
    by_stream: Dict[str, float] = collections.Counter()
    overlapped: Dict[Tuple[str, str], float] = collections.Counter()
    for start, end, stream, name in sorted(intervals,
                                            key=lambda i: (i[0], i[1])):
        dur = max(end - start, 0.0)
        total += dur
        by_stream[str(stream)] += dur
        over = min(max(cover_end - start, 0.0), dur)
        busy += dur - over
        if over > 0:
            overlapped[(str(stream), name[:80])] += over
            if stream == cover_stream:
                same += over
        if end > cover_end:
            cover_end, cover_stream = end, stream
    return {"device_ms": total / 1e3, "device_busy_ms": busy / 1e3,
            "device_overlap_ms": (total - busy) / 1e3,
            "device_same_stream_overlap_ms": same / 1e3,
            "device_ms_by_stream": {k: v / 1e3 for k, v in by_stream.items()},
            "overlap_top": [{"stream": s, "name": n, "ms": v / 1e3}
                            for (s, n), v in overlapped.most_common(6)]}


def trace_device_events(path: str) -> Tuple[List[dict], float]:
    """(device events, window us) of a Chrome trace written by
    torch.profiler: each kernel, copy and memset with its name, category,
    stream, start and duration (us); the window spans every event of the
    trace, host and device, that starts before the trace's first
    `TRAILING_MARK` range (`run_trailing`), all of them without one."""
    with open(path) as f:
        trace = json.load(f)
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    cut = min((float(e["ts"]) for e in events
               if e["name"] == TRAILING_MARK), default=float("inf"))
    events = [e for e in events if float(e["ts"]) < cut]
    if not events:
        return [], 0.0
    window = (max(e["ts"] + e["dur"] for e in events)
              - min(e["ts"] for e in events))
    device = [{"name": e["name"], "cat": e.get("cat", ""),
               "stream": e.get("args", {}).get("stream", e.get("tid")),
               "ts": float(e["ts"]), "dur": float(e["dur"])}
              for e in events if e.get("cat", "").lower() in DEVICE_CATEGORIES]
    return device, float(window)


ACTIVITY_FIELDS = ("device_ms", "device_busy_ms", "device_busy_share",
                   "device_overlap_ms", "device_same_stream_overlap_ms",
                   "device_ms_by_stream", "overlap_top")


def busy_fields(activity: Optional[dict], wall_ms: float) -> dict:
    """`device_activity` of a window of `wall_ms` with the union's share of
    it (`device_busy_share`, at most 1); each field None without device
    activity."""
    if not activity or not activity["device_ms"]:
        return dict.fromkeys(ACTIVITY_FIELDS)
    return {**activity,
            "device_busy_share": activity["device_busy_ms"] / wall_ms}


# The profiler has dropped the device records of a profile's last one or
# two CUDA graph replays. So a profile runs its work TRAILING_CALLS more
# times after what it measures, in a TRAILING_MARK range (`run_trailing`),
# and every event from that range on is left out (`before_trailing`,
# `trace_device_events`).
TRAILING_CALLS = 2
TRAILING_MARK = "profile_trailing"
MAS_KERNEL = r"\bmas_\w+_kernel"  # the MAS kernels' names (csrc/mas.cu)


def run_trailing(fn: Callable[[], object]) -> None:
    """fn() TRAILING_CALLS times in a TRAILING_MARK range, inside a
    profile and after the work it measures; fn ends in a device sync."""
    from torch.profiler import record_function

    with record_function(TRAILING_MARK):
        for _ in range(TRAILING_CALLS):
            fn()


def before_trailing(events: Sequence) -> list:
    """The profiler events (`prof.events()`) that start before the first
    TRAILING_MARK range, all of them without one."""
    cut = min((e.time_range.start for e in events
               if e.name == TRAILING_MARK), default=float("inf"))
    return [e for e in events if e.time_range.start < cut]


def _rows(events, device_type, cpu: bool) -> List[Tuple[str, float, int]]:
    """(name, self ms, count) of `events` of one device type, by name:
    `key_averages` of a slice of a profile."""
    ms: Dict[str, float] = collections.Counter()
    count: Dict[str, int] = collections.Counter()
    for e in events:
        if e.device_type == device_type:
            ms[e.name] += (e.self_cpu_time_total if cpu
                           else e.self_device_time_total) / 1e3
            count[e.name] += 1
    return [(k, ms[k], count[k]) for k in ms]


def profile_call(fn, trailing: Optional[Callable[[], object]] = None
                 ) -> dict:
    """fn() under torch.profiler: wall time, device time as the sum of the
    device events' durations (`device_ms`) and as the union of their
    intervals (`device_busy_ms`; `device_busy_share` is it over the wall,
    `device_overlap_ms` the sum less the union), launches (of kernels, of
    CUDA graphs, copies), MAS kernels run on the card and their device
    ms, top device kernels and top host ops. fn must end in a device
    sync. `trailing`, when given, runs after fn inside the profile
    (`run_trailing`) and is left out: a profile of a CUDA graph replay
    needs it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
        if trailing is not None:
            run_trailing(trailing)
    kept = before_trailing(list(prof.events()))
    intervals = [(e.time_range.start, e.time_range.end,
                  e.device_resource_id, e.name) for e in kept
                 if e.device_type == DeviceType.CUDA]
    activity = device_activity(intervals)
    # device rows are the kernels, copies and memsets themselves; an op's
    # own row repeats its kernels' time, so only these are read
    dev = _rows(kept, DeviceType.CUDA, cpu=False)
    host = _rows(kept, DeviceType.CPU, cpu=True)
    mas = [(k, ms, c) for k, ms, c in dev if re.search(MAS_KERNEL, k)]

    def top(rows):
        return [{"name": k[:80], "ms": ms, "calls": c}
                for k, ms, c in sorted(rows, key=lambda r: -r[1])[:6]]

    return {"wall_ms_profiled": wall_ms, **busy_fields(activity, wall_ms),
            "cuda_launch_kernel_calls": sum(
                c for k, _, c in host if k.startswith("cudaLaunchKernel")),
            "cuda_graph_launch_calls": sum(
                c for k, _, c in host if k.startswith("cudaGraphLaunch")),
            "cuda_memcpy_calls": sum(
                c for k, _, c in host if k.startswith("cudaMemcpy")),
            "mas_device_ms": sum(ms for _, ms, _ in mas),
            "mas_kernels": {k: c for k, _, c in mas},
            "top_device": top(dev), "top_host": top(host)}


def busy(fn, device) -> dict:
    """`profile_call`'s device fields of fn on a card (each call ended by
    a sync, trailing ones left out); on the CPU fn runs once and each
    field is None."""
    if torch.device(device).type != "cuda":
        fn()
        return busy_fields(None, 0.0)

    def call():
        fn()
        torch.cuda.synchronize(device)

    prof = profile_call(call, trailing=call)
    return {k: prof[k] for k in ("device_ms", "device_busy_ms",
                                 "device_busy_share", "device_overlap_ms")}


CALL_MARK = "busy_call_"  # the record_function range of each profiled call


def calls_busy_ms(intervals: Sequence[Tuple[float, float, object, str]],
                  starts: Sequence[float]) -> List[float]:
    """The union (ms) of each call's device intervals (start_us, end_us,
    stream, name), calls ending in a device sync and starting at `starts`
    (host us, ascending): an interval belongs to the last call that
    started at or before it."""
    ends = list(starts[1:]) + [float("inf")]
    return [device_activity([iv for iv in intervals if s <= iv[0] < e]
                            )["device_busy_ms"] for s, e in zip(starts, ends)]


def busy_ms(fn, device, calls: int = 5) -> Optional[List[float]]:
    """The card's own time of each of `calls` calls of fn: the union of
    the call's device activity intervals, which the host's dispatch does
    not lengthen. One profile holds a first call, not reported, the timed
    ones, each in a record_function range and ended by a device sync, and
    trailing ones that are left out (`run_trailing`). Raises if the
    profiler saw no device activity in a timed call. On the CPU fn runs
    once and the result is None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    if torch.device(device).type != "cuda":
        fn()
        return None

    def call():
        fn()
        torch.cuda.synchronize(device)

    call()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls + 1):
            with record_function(f"{CALL_MARK}{i}"):
                call()
        run_trailing(call)
    starts, intervals = {}, []
    for e in before_trailing(list(prof.events())):
        if e.name.startswith(CALL_MARK):
            # a call's host range; its span on the card is not work
            if e.device_type == DeviceType.CPU:
                starts[int(e.name[len(CALL_MARK):])] = e.time_range.start
        elif e.device_type == DeviceType.CUDA:
            intervals.append((e.time_range.start, e.time_range.end,
                              e.device_resource_id, e.name))
    times = calls_busy_ms(intervals, sorted(starts.values()))[1:]
    if not all(times):
        raise RuntimeError(f"the profiler saw no device activity in a call "
                           f"of {fn}: {times}")
    return times


def busy_median_ms(fn, device, calls: int = 5) -> Optional[float]:
    """Median of `busy_ms`; None on the CPU."""
    times = busy_ms(fn, device, calls)
    return None if times is None else statistics.median(times)


# ---------------------------------------------------------------------------
# FLOP and byte counts
# ---------------------------------------------------------------------------


class ByteCounter(TorchDispatchMode):
    """Bytes of each aten op's operands and results, views left out: the
    pre-fusion upper bound that XLA's "bytes accessed" is (each operand
    and result of each op counted, whatever a fused kernel keeps on
    chip)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.nbytes for t in tree_flatten((args, kwargs,
                                                               out))[0]
                              if isinstance(t, torch.Tensor))
        return out


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, transposed, _output_padding,
                         _groups, output_mask, out_shape=None, **_) -> int:
    """A convolution's backward: each gradient it computes (input, weight)
    costs the forward's FLOPs. torch's own formula counts a grouped
    convolution's weight gradient `groups` times over (each group's
    product taken over every input channel)."""
    from torch.utils.flop_counter import conv_flop_count

    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def count(fn: Callable[[], object]) -> dict:
    """fn() under FlopCounterMode and a ByteCounter: its FLOPs (the matmul,
    convolution and attention ops torch counts, forward and backward), its
    bytes, and the FLOPs of each module by op ({module: {op: flops}};
    backward ops are attributed to modules only roughly)."""
    from torch.utils.flop_counter import FlopCounterMode

    fixed = {torch.ops.aten.convolution_backward: _conv_backward_flops}
    with FlopCounterMode(display=False, custom_mapping=fixed) as flops, \
            ByteCounter() as nbytes:
        fn()
    by_module = {mod: {str(op).split(".")[-1]: int(v) for op, v in ops.items()}
                 for mod, ops in flops.get_flop_counts().items()}
    return {"flops": int(flops.get_total_flops()), "bytes": int(nbytes.bytes),
            "by_module": by_module}


def speed_of_light(flops: float, nbytes: float, peak_ops_per_s: float,
                   hbm_bytes_per_s: float = HBM_BYTES_PER_S) -> dict:
    """The least time of a count at the card's peaks: FLOPs over the peak,
    bytes over the memory rate, and the larger of the two."""
    ops_ms = flops / peak_ops_per_s * 1e3
    bytes_ms = nbytes / hbm_bytes_per_s * 1e3
    return {"gflop": flops / 1e9, "gbytes": nbytes / 1e9, "sol_ms": ops_ms,
            "bw_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def iqr(values: Sequence[float]) -> float:
    q1, q3 = np.percentile(values, [25, 75])
    return float(q3 - q1)
