"""teach_ms_per_tick: the set-up's teach (``run_campaign_teach``, which
ends in its traces' copy to the host) on the host clock, over the teach
ticks it executed."""


def read(ctx):
    if not ctx.get("teach_ticks"):
        return None
    return ctx["teach_s"] / ctx["teach_ticks"] * 1e3
