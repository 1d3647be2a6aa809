"""What the per-layer metric files share. Each reader takes the run's
context (ctx: "stage", "spans", "trace", "units", "window_s") and returns
a number, or None where it finds nothing to read."""
from __future__ import annotations

from benchmark import costs
from benchmark.harness import device_time


def idle_share(ctx):
    """%: the window less the union of the device's operations."""
    tr = ctx["trace"]
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(ctx, span: str):
    """%: the counted FLOPs of the window's units at the chip's float32
    peak, over the summed wall of their spans."""
    wall = ctx["spans"].total(span)
    flops, _ = ctx["stage"].counted_work()
    if wall <= 0 or flops <= 0:
        return None
    return 100.0 * flops * ctx["units"] / costs.PEAK_FLOPS[4] / wall


def roofline(ctx, names):
    """%: the least time of the window's counted work (the larger of its
    bytes at the memory rate and its FLOPs at the peak) over the device
    time of the operations named `names`."""
    tr = ctx["trace"]
    if not tr:
        return None
    dev = device_time(tr, None, names)
    flops, nbytes = ctx["stage"].counted_work()
    if dev <= 0 or flops <= 0:
        return None
    return 100.0 * costs.bound_s(nbytes, flops)[0] * ctx["units"] / dev
