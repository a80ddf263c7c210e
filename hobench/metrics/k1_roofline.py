"""K1's share of its roofline, in %: the least time of a batch's whole-run
launch (its drawn links times the link stream's operations over the
integer pipes' peak, or its bytes over HBM's), averaged over the first
traced batches, over the mean device time of the launches of csrc/
hist_loop.cu's kernel in every traced batch."""

from hobench import roofline

KERNEL = "hist_loop_kernel"


def read(ctx):
    rec = ctx.record
    if rec.trace is None or not rec.kept:
        return None
    ms = roofline.kernel_ms_per_batch(rec.trace, KERNEL)
    if ms is None:
        return None
    bound = sum(roofline.loop_bound_ms(ctx.cell, k)
                for k in rec.kept) / len(rec.kept)
    return 100.0 * bound / ms
