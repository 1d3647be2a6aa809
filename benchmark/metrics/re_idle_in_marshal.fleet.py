"""re_idle_in_marshal.fleet: the device's idle time inside the RE model's
marshal (the program's `re.marshal_dispatch` spans, on the trace's clock,
less the device operations that overlap them), as a share of the
window's idle time."""
from benchmark.program_spans import idle_inside


def read(ctx):
    return idle_inside(ctx, "re.marshal_dispatch")
