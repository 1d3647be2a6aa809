"""fe_objective_host_ms_per_funcall.criteo: the host's time in the
objective's calls (the program's `lbfgs.objective` spans, taken by the
L-BFGS loop around each call: the dispatch of a funcall and any wait
inside it) over the window's funcalls."""
from benchmark.program_spans import ms_per_funcall


def read(ctx):
    return ms_per_funcall(ctx, ("lbfgs.objective",))
