"""re_bucketize_share.fleet: the bucketizer's steps (the program's
`re.bucketize` spans, each next() of data/bucketing.py's
iter_bucketize_flat inside RandomEffectLRModel.fit_groups) summed over the
window's fits, as a share of their walls."""
from benchmark.program_spans import share_of_fits


def read(ctx):
    return share_of_fits(ctx, "re.bucketize")
