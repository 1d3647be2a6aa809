"""mfu.modernbert: the fits' counted FLOPs (each step's forward and
backward over its batch's documents, attention by the pairs each layer
computes, and the validation pass; costs/modernbert.py) at the chip's
float32 peak over the fits' walls."""
from benchmark.readers import mfu


def read(ctx):
    return mfu(ctx, "fit")
