"""re_marshal_share.fleet: the RE model's host marshal and dispatch
(RandomEffectLRModel.last_fit_phases["marshal_dispatch"]) summed over the
window's fits, as a share of their walls."""


def read(ctx):
    sp = ctx["spans"]
    wall = sp.total("fit")
    md = sp.counters.get("fit.marshal_dispatch")
    return None if not wall or md is None else 100.0 * md / wall
