"""Seconds from the process's start to the first timed call: imports, the inputs drawn
from the seed, the load, kernel builds where a checkout has none yet, the warm-up."""

UNIT = "s"


def read(ctx):
    return ctx.setup_s
