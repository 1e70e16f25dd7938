"""Share of the window in which the interpreter's garbage collector ran (timed through
``gc.callbacks``), in per cent: a collection holds every client at once."""

UNIT = "%"


def read(ctx):
    win = ctx.window
    if not win.calls or win.seconds <= 0:
        return None
    return 100.0 * sum(s for _, s in win.gc_pauses) / win.seconds
