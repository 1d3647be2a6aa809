"""tower_adam_ms_per_step.bert: the device time of the operations launched
inside the program's `tower.adam` spans (the fused Adam update; torch.optim
annotates its step as `Optimizer.step#Adam.step` inside the span, and the
trace names the update by that innermost annotation), over the window's
steps."""
from benchmark.harness import device_time

ADAM = ("tower.adam", "Optimizer.step#Adam.step")


def read(ctx):
    steps = ctx["spans"].counters.get("fit.steps")
    tr = ctx["trace"]
    dev = sum(device_time(tr, s) for s in ADAM) if tr else 0
    return None if not steps or dev <= 0 else 1e3 * dev / steps
