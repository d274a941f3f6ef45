"""k2_roofline_pct: K2's least time over its device time in the traced
call.  The least time sums each launch's larger bound: min-plus operations
(18 a cell and iteration) over the float32 peak, or bytes over the HBM
peak (``k2_least_s``)."""

from pbench.roofline import k2_least_s

KERNEL = "relax_kernel"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    n, dev_s = tr.device_s(KERNEL)
    shapes = tr.shapes.get("k2", [])
    if n == 0 or dev_s <= 0 or len(shapes) != n:
        return None
    return 100.0 * sum(k2_least_s(s)[0] for s in shapes) / dev_s
