"""mfu.fleet: the fits' counted FLOPs at the chip's float32 peak over the
fits' walls."""
from benchmark.readers import mfu


def read(ctx):
    return mfu(ctx, "fit")
