"""Queries answered in the window over the window's seconds (every call of the window,
from the first start to the last return)."""

UNIT = "queries/s"


def read(ctx):
    win = ctx.window
    if not win.calls or win.seconds <= 0:
        return None
    answered = (len(win.calls) - len(win.failed)) * int(ctx.traffic["batch"])
    return answered / win.seconds
