"""Timing / profiling / memory instrumentation.

Port of gdmix_tpu/util/timing.py. The reference's observability is
wall-clock log lines per phase plus the resident set per L-BFGS funcall;
this module keeps that surface and puts it on one span recorder:

- `span(name)`: a context manager that reads `time.perf_counter_ns()` on
  entry and exit and gives its caller the seconds between (`.seconds`).
  While a torch.profiler records, and only then, the span is also a
  `record_function` annotation of the trace, so the trace names the device
  work and the idle time by the program's innermost span, and the span
  goes into a bounded log (a ring of RING entries with a count of those
  dropped; `span_log()`). With no profiler on a span costs the clock pair.
  The switch is the profiler being on: no setting, no environment
  variable.
- `to_trace_ns(t)`: a `perf_counter_ns` stamp on the trace's clock, the
  Unix-epoch nanoseconds that torch.profiler's events carry.
- `phase(name)`: a span that also logs the reference's line, with the
  resident set.
- `device_profile(...)` wraps a block in a torch.profiler trace of the CPU
  and CUDA activity (set GDMIX_TPU_PROFILE=/dir or pass log_dir), viewable
  in TensorBoard or chrome://tracing; the program's spans are its
  annotations.
- `measure_dispatch_latency_s(device)` probes one launch and read-back
  round trip.

A span opens and closes in one frame, never across a `yield`. The
program's span names start with `re.`, `lbfgs` or `tower.`.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import logging
import os
import time
from typing import Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

from gdmix_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


def rss_gb() -> float:
    """Resident set size in GB (psutil if present, /proc fallback)."""
    try:
        import psutil
        return psutil.Process(os.getpid()).memory_info().rss / 1e9
    except ImportError:
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            return pages * os.sysconf("SC_PAGE_SIZE") / 1e9
        except OSError:
            return float("nan")


# entries the span log keeps; older ones are dropped and counted
RING = 65536


class _Log:
    """The spans recorded under a profiler: (name, t0, t1) in
    perf_counter nanoseconds, the newest `capacity`, in the order they
    closed, and the count of those dropped to keep that bound."""

    def __init__(self, capacity: int = RING):
        self.entries = collections.deque(maxlen=capacity)
        self.dropped = 0

    def add(self, entry: Tuple[str, int, int]) -> None:
        if len(self.entries) == self.entries.maxlen:
            self.dropped += 1
        self.entries.append(entry)


_LOG = _Log()


class span:
    """`with span(name) as s:` times its block (`s.seconds` once it has
    closed). Under a profiler the block is also a `record_function`
    annotation named `name`, and the span goes into the log."""

    __slots__ = ("name", "t0", "t1", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self) -> "span":
        if _autograd_profiler._is_profiler_enabled:
            self._rf = _autograd_profiler.record_function(self.name)
        # read before the annotation opens: it takes its stamp on entry,
        # then (the first time) ~1 ms more of its own set-up
        self.t0 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
            _LOG.add((self.name, self.t0, self.t1))

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


def span_log() -> Tuple[List[Tuple[str, int, int]], int]:
    """(the logged spans, (name, t0, t1) in perf_counter nanoseconds, in
    the order they closed; how many older ones were dropped)."""
    return list(_LOG.entries), _LOG.dropped


def to_trace_ns(t: int) -> int:
    """perf_counter nanoseconds `t` on the clock of torch.profiler's
    events (Unix-epoch nanoseconds): the offset between the two clocks
    read now, from the tightest of three readings."""
    best = None
    for _ in range(3):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return t + best[1]


class phase(span):
    """Wall-clock + RSS phase timer (the reference's per-phase log lines):
    a span that logs its line when it closes."""

    __slots__ = ("log", "_rss0")

    def __init__(self, name: str, log=logger):
        super().__init__(name)
        self.log = log

    def __enter__(self) -> "phase":
        self._rss0 = rss_gb()
        return super().__enter__()

    def __exit__(self, *exc) -> None:
        super().__exit__(*exc)
        self.log.info("%s --- %.3f seconds --- memory used: %.2f GB "
                      "(Δ%+.2f)", self.name, self.seconds, rss_gb(),
                      rss_gb() - self._rss0)


@contextlib.contextmanager
def device_profile(log_dir: Optional[str] = None) -> Iterator[None]:
    """torch.profiler trace of the CPU and (where there is a card) CUDA
    activity around a block, written into log_dir as a chrome trace
    (`*.pt.trace.json`). Active when log_dir is given or GDMIX_TPU_PROFILE
    is set; no-op otherwise."""
    log_dir = log_dir or os.environ.get("GDMIX_TPU_PROFILE")
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
    logger.info("Wrote device trace to %s", log_dir)


@functools.lru_cache(maxsize=None)
def _dispatch_latency_s(device: str) -> float:
    x = torch.zeros((), device=device)
    (x + 1.0).item()  # the first launch: context and kernel load
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        (x + 1.0).item()
        ts.append(time.perf_counter() - t0)
    lat = min(ts)
    logger.info("measured dispatch latency on %s: %.3f ms", device,
                lat * 1e3)
    return lat


def measure_dispatch_latency_s(device=None) -> float:
    """One-time per-process probe of `device`'s dispatch round trip: the
    wall of a one-element op plus its read back (`.item()`), the minimum
    of 3 after one warm-up. The card by default, as resolve_device has it."""
    return _dispatch_latency_s(str(resolve_device(device)))


def nominal_dispatch_latency_s(device=None) -> float:
    """The measured dispatch latency CLASSIFIED to a stable nominal value,
    by the JAX package's rule: 25 ms relay-class, else 1 ms (local dispatch
    plus the ~ms per-bucket host-marshal floor that rides every extra
    bucket regardless of link). A plan must not move with run-to-run
    latency jitter, so a decision keys on the CLASS, not the sample. The
    port's bucket plan does not call this: data/bucketing.py fixes the
    1 ms class."""
    lat = measure_dispatch_latency_s(device)
    return 25e-3 if lat >= 5e-3 else 1e-3
