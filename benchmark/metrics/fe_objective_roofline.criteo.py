"""fe_objective_roofline.criteo: one funcall's counted work (every entry
read once, the gradient written once) at its least time, over the device
time a funcall's operations take (those launched inside the objective's
calls)."""
from benchmark import costs
from benchmark.harness import device_time


def read(ctx):
    st, calls = ctx["stage"], ctx["spans"].counters.get("fit.funcalls")
    dev = device_time(ctx["trace"], "fit.objective") if ctx["trace"] else 0
    if not calls or dev <= 0:
        return None
    k = st.data.indices.shape[1]
    least, _ = costs.bound_s(costs.funcall_bytes(st.n, k, st.width),
                             costs.funcall_flops(st.n, k))
    return 100.0 * least * calls / dev
