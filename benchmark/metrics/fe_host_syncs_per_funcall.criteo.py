"""fe_host_syncs_per_funcall.criteo: the L-BFGS loop's host syncs over its
funcalls (FixedEffectLRModel.last_fit, summed over the window's fits)."""


def read(ctx):
    c = ctx["spans"].counters
    calls = c.get("fit.funcalls")
    return None if not calls else c.get("fit.host_syncs", 0.0) / calls
