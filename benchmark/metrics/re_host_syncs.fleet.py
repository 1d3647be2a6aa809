"""re_host_syncs.fleet: synchronising calls a fit, counted by PyTorch's
sync debug mode over one fit after the window (benchmark/syncs.py)."""


def read(ctx):
    return ctx["spans"].counters.get("syncs_per_fit")
