"""What every cell shares: finding a cell, its configuration, its kind and
its metric readers by name; the device checks; spans; the reduction of a
profiler trace; and the one result line.

Everything a later cell brings is a file the harness finds by name:

    benchmark/traffic/<cell>.json    the traffic mix, with the cell's
                                     configuration, kind and limits
    benchmark/configs/<config>.json  the configuration as it is run
    benchmark/kinds/<kind>.py        the general driver of a kind of work
    benchmark/metrics/<metric>.py    a per-layer metric's reader:
                                     read(ctx) -> number or None
"""
from __future__ import annotations

import bisect
import importlib
import importlib.util
import json
import os
import sys
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# the program's build cache: the port's default, inside the checkout
BUILD_DIR = os.path.join(ROOT, "build", "gdmix_tpu_torch")
# what no process that prints a result may hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "gdmix_tpu")


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """The cell `name`: its traffic file, with its configuration under
    "cfg"."""
    t = _json("traffic", f"{name}.json")
    t["cfg"] = _json("configs", f"{t['config']}.json")
    t["name"] = name
    return t


def kind(name: str):
    """The module that drives work of kind `name`."""
    return importlib.import_module(f"benchmark.kinds.{name}")


def reader(metric: str):
    """The `read` function of a per-layer metric's file."""
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(m: dict, workload: str, section: str) -> List[dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") the cell
    reports: those that list it under "workloads", and those without the
    key that move (or are) an end-to-end metric the cell reports."""
    e2e = {x["name"] for x in m["end_to_end"]
           if workload in x.get("workloads", [workload])}
    out = []
    for x in m[section]:
        if "workloads" in x:
            if workload in x["workloads"]:
                out.append(x)
        elif x["name"] in e2e or x.get("moves") in e2e:
            out.append(x)
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole."""
    return sorted({k for k in list(sys.modules)
                   if k.split(".")[0] in FORBIDDEN})


def process_age_s() -> Optional[float]:
    """Seconds since this process started (Linux: /proc), or None."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return None


def say(line: str) -> None:
    sys.stderr.write(line + "\n")
    sys.stderr.flush()


class Spans:
    """Host-clock spans from the benchmark's own files, around calls into
    the program: (name, start, end) in perf_counter seconds. Under a
    profiler each span is also a user annotation of the trace, so the
    trace's device work can be named by the span that launched it."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.items: List[tuple] = []
        self.counters: Dict[str, float] = {}

    @contextmanager
    def span(self, name: str):
        rf = None
        if self.traced:
            from torch.profiler import record_function
            rf = record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.items.append((name, t0, t1))

    def add(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def total(self, name: str) -> float:
        """Summed seconds of the spans named `name`."""
        return sum(b - a for n, a, b in self.items if n == name)


_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
             "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
             "cudaMemcpy", "cudaMemset", "cudaLaunchCooperativeKernel")


def reduce_trace(prof, window_s: float) -> dict:
    """From a torch.profiler run over the window: the device's operations
    as (name, start_ns, dur_ns, span), where span is the innermost
    benchmark span whose interval holds the operation's launch; the union
    of their intervals (busy seconds); the largest operations by total
    time; and the longest idle gaps, each named by the span the host was
    in at the gap's middle."""
    import torch
    events = prof.profiler.kineto_results.events()
    spans, launches, ops = [], {}, []
    for e in events:
        dev = e.device_type()
        if dev == torch.autograd.DeviceType.CPU:
            if e.is_user_annotation():
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              e.name()))
            elif e.name() in _LAUNCHES:
                launches[e.correlation_id()] = e.start_ns()
        elif dev == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation():
            ops.append((e.name(), e.start_ns(), e.duration_ns(),
                        e.correlation_id()))
    spans.sort()
    starts = [a for a, _, _ in spans]

    def span_at(t):
        # spans nest: the latest-started span that still holds t is the
        # innermost
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0:
            if spans[i][1] >= t:
                return spans[i][2]
            i -= 1
        return "outside"

    out_ops = [(name, s, d, span_at(launches.get(c, s)))
               for name, s, d, c in ops]
    window = next(((a, b) for a, b, name in spans if name == "window"),
                  None)
    busy_ns, gaps, end = 0, [], (window[0] if window else None)
    for _, s, d, _ in sorted(out_ops, key=lambda o: o[1]):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy_ns += d
            end = s + d
        elif s + d > end:
            busy_ns += s + d - end
            end = s + d
    if window and end is not None and window[1] > end:
        gaps.append((end, window[1]))
    by_name: Dict[str, float] = {}
    for name, _, d, _ in out_ops:
        by_name[name] = by_name.get(name, 0.0) + d / 1e9
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[span_at((a + b) // 2), (b - a) / 1e9] for a, b in gaps[:10]]
    return dict(ops=out_ops, busy_s=busy_ns / 1e9, window_s=window_s,
                device_ops=[[n[:120], s] for n, s in top_ops],
                idle_gaps=idle)


def device_time(trace: dict, span_prefix: Optional[str] = None,
                names=()) -> float:
    """Seconds of device operations launched inside spans named
    `span_prefix` (or any) whose names contain one of `names` (or any)."""
    tot = 0
    for name, _, d, span in trace["ops"]:
        if span_prefix and not (span == span_prefix
                                or span.startswith(span_prefix + ".")):
            continue
        if names and not any(n in name for n in names):
            continue
        tot += d
    return tot / 1e9


def result_line(correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: list,
                breakdown: Optional[dict] = None) -> str:
    """The one JSON line, its compared numbers under "checks", last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return json.dumps(out)
