"""re_solve_roofline.fleet: the solves' counted work (the reference's
Newton iterations at each entity's rows and dim) at its least time, over
the device time of the solver kernels (csrc/newton_lanes.cu,
newton_kernel) in the window."""
from benchmark.readers import roofline


def read(ctx):
    return roofline(ctx, ("newton_kernel",))
