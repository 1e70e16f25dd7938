"""Median latency of the window's calls, each from its start to its return, on the
host's clock."""

UNIT = "ms"


def read(ctx):
    return ctx.window.latency_ms(50)
