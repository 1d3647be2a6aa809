"""mfu.bert: the fits' counted FLOPs (each step's forward and backward over
its batch's real positions, and the validation pass) at the chip's
float32 peak over the fits' walls."""
from benchmark.readers import mfu


def read(ctx):
    return mfu(ctx, "fit")
