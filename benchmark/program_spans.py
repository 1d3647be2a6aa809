"""What the per-layer metrics of the program's own spans share.

The program records its spans through gdmix_tpu_torch.util.timing while a
profiler records (a `--trace 1` run): (name, t0, t1) in perf_counter
nanoseconds, the clock of the benchmark's spans, in a bounded log. These
helpers read the spans that started inside the benchmark's `window` span.
They read the log through the program's module, not through the model,
which is freed before the readers run. Each returns None where there is
nothing whole to read: a program without the recorder, no window span, or
a log that dropped spans of the window.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

Intervals = List[Tuple[int, int]]


def window_spans(ctx) -> Optional[Dict[str, Intervals]]:
    """{name: [(t0, t1), ...]} of the program's spans that started inside
    the window, in perf_counter nanoseconds; or None."""
    try:
        from gdmix_tpu_torch.util.timing import span_log
    except ImportError:
        return None
    win = next(((a, b) for n, a, b in ctx["spans"].items if n == "window"),
               None)
    if win is None:
        return None
    w0, w1 = int(win[0] * 1e9), int(win[1] * 1e9)
    entries, dropped = span_log()
    # the log keeps spans in the order they closed, so every dropped span
    # closed before the oldest kept one: none of them can have started in
    # the window if that one closed before it
    if dropped and (not entries or entries[0][2] >= w0):
        return None
    out: Dict[str, Intervals] = {}
    for name, t0, t1 in entries:
        if w0 <= t0 <= w1:
            out.setdefault(name, []).append((t0, t1))
    return out


def total_s(spans: Dict[str, Intervals], name: str) -> float:
    """Summed seconds of the spans named `name`."""
    return sum(b - a for a, b in spans.get(name, ())) / 1e9


def share_of_fits(ctx, name: str) -> Optional[float]:
    """%: the seconds of the program's spans `name` over the summed walls
    of the benchmark's `fit` spans."""
    spans = window_spans(ctx)
    wall = ctx["spans"].total("fit")
    if spans is None or name not in spans or wall <= 0:
        return None
    return 100.0 * total_s(spans, name) / wall


def ms_per_funcall(ctx, plus: Tuple[str, ...],
                   minus: Tuple[str, ...] = ()) -> Optional[float]:
    """ms: the seconds of the spans `plus` less those of the spans `minus`,
    over the funcalls the window's fits made (the benchmark's
    `fit.funcalls` counter)."""
    spans = window_spans(ctx)
    calls = ctx["spans"].counters.get("fit.funcalls")
    if spans is None or not calls or not all(n in spans for n in plus):
        return None
    s = (sum(total_s(spans, n) for n in plus)
         - sum(total_s(spans, n) for n in minus))
    return 1e3 * s / calls


def _union(ops) -> Intervals:
    """The union of the device operations' intervals (start, end), on the
    trace's clock, in order."""
    out: Intervals = []
    for _, s, d, _ in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            if s + d > out[-1][1]:
                out[-1] = (out[-1][0], s + d)
        else:
            out.append((s, s + d))
    return out


def _covered(busy: Intervals, starts: List[int], a: int, b: int) -> int:
    """Nanoseconds of [a, b] that the sorted, disjoint `busy` covers."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    tot = 0
    while i < len(busy) and busy[i][0] < b:
        lo, hi = max(busy[i][0], a), min(busy[i][1], b)
        if hi > lo:
            tot += hi - lo
        i += 1
    return tot


def idle_inside(ctx, name: str) -> Optional[float]:
    """%: the device's idle seconds inside the program's spans `name` (each
    span on the trace's clock, less the union of the device operations
    that overlap it) over the window's idle seconds (window_s − busy_s)."""
    tr = ctx["trace"]
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= tr["busy_s"]:
        return None
    spans = window_spans(ctx)
    if spans is None or name not in spans:
        return None
    from gdmix_tpu_torch.util import timing
    busy = _union(tr["ops"])
    starts = [a for a, _ in busy]
    idle_ns = 0
    for a, b in spans[name]:
        a, b = timing.to_trace_ns(a), timing.to_trace_ns(b)
        idle_ns += (b - a) - _covered(busy, starts, a, b)
    return 100.0 * idle_ns / 1e9 / (tr["window_s"] - tr["busy_s"])
