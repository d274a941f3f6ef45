"""k1_roofline_pct: K1's least time over its device time in the traced
call.  The least time sums each launch's bytes bound (``k1_bytes`` of the
shape it was launched at over the HBM peak): K1's b1 tensor-core MMAs
have no published rate, and the float32 peak does not bound them."""

from pbench.roofline import k1_least_s

KERNEL = "cross_check_kernel"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    n, dev_s = tr.device_s(KERNEL)
    shapes = tr.shapes.get("k1", [])
    if n == 0 or dev_s <= 0 or len(shapes) != n:
        return None
    return 100.0 * sum(k1_least_s(s) for s in shapes) / dev_s
