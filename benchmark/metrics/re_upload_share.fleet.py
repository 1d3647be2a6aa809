"""re_upload_share.fleet: the buckets' uploads (the program's `re.upload`
spans around RandomEffectLRModel._bucket_device_arrays) summed over the
window's fits, as a share of their walls."""
from benchmark.program_spans import share_of_fits


def read(ctx):
    return share_of_fits(ctx, "re.upload")
