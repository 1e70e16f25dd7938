"""Share of the traced part of the window in which no operation ran on the device."""

UNIT = "%"


def read(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
