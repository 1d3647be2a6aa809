"""tower_step_roofline.modernbert: the steps' counted work
(costs/modernbert.py, over their documents) at its least time, over the
device time of the operations launched inside the program's `tower.step`
spans and the spans inside them (`tower.forward`, `tower.backward`,
`tower.adam` and torch.optim's `Optimizer.step#Adam.step` in it, the
attention calls' `tower.attention.*` and their backward's
`tower.attention_grad.*`)."""
from benchmark import costs
from benchmark.harness import device_time

SPANS = ("tower.step", "tower.forward", "tower.backward", "tower.adam",
         "Optimizer.step#Adam.step", "tower.attention",
         "tower.attention_grad")


def read(ctx):
    tr = ctx["trace"]
    dev = sum(device_time(tr, s) for s in SPANS) if tr else 0
    if dev <= 0:
        return None
    least = sum(costs.bound_s(nbytes, flops)[0]
                for flops, nbytes in ctx["stage"].step_work())
    return 100.0 * least * ctx["units"] / dev
