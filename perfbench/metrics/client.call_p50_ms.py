"""Median latency of the window's calls, each from its start to its return, on the
host's clock (the per-layer reading, in cells where the host paces the calls)."""

UNIT = "ms"


def read(ctx):
    return ctx.window.latency_ms(50)
