"""fe_device_ms_per_funcall.criteo: device time of the operations launched
inside the objective's calls (the benchmark's span around each call of
FixedEffectLRModel._objective_fun's function) over the funcalls."""
from benchmark.harness import device_time


def read(ctx):
    calls = ctx["spans"].counters.get("fit.funcalls")
    dev = device_time(ctx["trace"], "fit.objective") if ctx["trace"] else 0
    return None if not calls or dev <= 0 else 1e3 * dev / calls
