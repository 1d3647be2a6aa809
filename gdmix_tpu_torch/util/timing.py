"""Timing / profiling / memory instrumentation.

Port of gdmix_tpu/util/timing.py. The reference's observability is
wall-clock log lines per phase plus the resident set per L-BFGS funcall;
this module keeps that surface — `phase(...)` context timers with RSS
deltas — and adds what the card offers: `device_profile(...)` wraps a block
in a torch.profiler trace of the CPU and CUDA activity (set
GDMIX_TPU_PROFILE=/dir or pass log_dir), viewable in TensorBoard or
chrome://tracing, and `measure_dispatch_latency_s(device)` probes one launch
and read-back round trip.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from typing import Iterator, Optional

import torch

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


@contextlib.contextmanager
def phase(name: str, log=logger) -> Iterator[None]:
    """Wall-clock + RSS phase timer (the reference's per-phase log lines)."""
    t0 = time.time()
    r0 = rss_gb()
    try:
        yield
    finally:
        log.info("%s --- %.3f seconds --- memory used: %.2f GB (Δ%+.2f)",
                 name, time.time() - t0, rss_gb(), rss_gb() - r0)


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
