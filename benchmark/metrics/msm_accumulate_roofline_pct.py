"""The bucket accumulate's share of its roofline: the least time of the
additions that the traced calls' digits need (benchlib.roofline.bucket_work:
a mixed addition for each point after the first in a bucket, the running
sum's general additions) over the device time of the accumulate's kernels
(bucket sort, accumulate, reduce) in those calls."""

from benchlib import roofline as RF


def read(trace, ctx, spec):
    t = trace.kernel_device_s(spec["kernels"])
    facts = ctx.facts()
    if t is None or not facts:
        return None
    products = sum(RF.accumulate_products(f["ncoords"], f["mixed"], f["general"]) for f in facts)
    nbytes = sum(RF.accumulate_bytes(f["ncoords"], f["points"], f["windows"], f["lanes"])
                 for f in facts)
    return 100.0 * RF.least_seconds(products, nbytes) / t
