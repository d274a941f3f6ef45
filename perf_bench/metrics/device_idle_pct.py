"""device_idle_pct: the share of the traced call's wall time in which no
operation ran on the device (100 - the union of the device operations'
intervals over the traced window)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
