"""launches_per_tick: kernels on the device a repeat tick, from the
profiler's device operations over the traced call's ticks (copies and
memsets not counted)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.kernels:
        return None
    return len(tr.kernels) / ctx["traced_ticks"]
