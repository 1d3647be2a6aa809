"""tower_attention_roofline.bert: the steps' forward attention (QKᵀ and PV
over the real positions, costs/tower.py) at its least time, over the device
time of the operations launched inside the program's `tower.attention`
spans (scaled_dot_product_attention in a step's forward)."""
from benchmark import costs
from benchmark.harness import device_time


def read(ctx):
    tr = ctx["trace"]
    dev = device_time(tr, "tower.attention") if tr else 0
    if dev <= 0:
        return None
    flops, nbytes = ctx["stage"].attention_work()
    least, _ = costs.bound_s(nbytes, flops)
    return 100.0 * least * ctx["units"] / dev
