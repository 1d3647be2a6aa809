"""tower_full_attention_roofline.modernbert: the global layers' attention (each
query over its whole document) in the steps, forward and backward, counted by
costs/modernbert.py over the pairs each query needs, at its least time,
over the device time of the operations launched inside the program's
`tower.attention.full` spans (a step's forward) and
`tower.attention_grad.full` spans (its backward): the share of its
roofline that csrc/varlen_attention.cu reaches there."""
from benchmark.harness import device_time

KIND = "full"


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    dev = (device_time(tr, f"tower.attention.{KIND}")
           + device_time(tr, f"tower.attention_grad.{KIND}"))
    if dev <= 0:
        return None
    return 100.0 * ctx["stage"].attention_least_s(KIND) * ctx["units"] / dev
