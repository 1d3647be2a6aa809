"""fe_lbfgs_host_ms_per_funcall.criteo: the L-BFGS loop's own host time
(the program's `lbfgs` spans less their `lbfgs.objective` and
`lbfgs.fetch` spans, ops/lbfgs.py) over the window's funcalls."""
from benchmark.program_spans import ms_per_funcall


def read(ctx):
    return ms_per_funcall(ctx, ("lbfgs",), ("lbfgs.objective", "lbfgs.fetch"))
