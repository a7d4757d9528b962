"""The Miller kernel's share of its roofline: the least time of the Fq
products that the traced calls' Miller loops need (benchlib.roofline, from
the crate's formulas) over the kernel's device time in those calls."""

from benchlib import roofline as RF


def read(trace, ctx, spec):
    t = trace.kernel_device_s(spec["kernels"])
    facts = ctx.facts()
    if t is None or not facts:
        return None
    products = sum(RF.miller_products(f["entry"], f["finite_pairs"]) for f in facts)
    nbytes = sum(RF.miller_bytes(f["pairs"]) for f in facts)
    return 100.0 * RF.least_seconds(products, nbytes) / t
