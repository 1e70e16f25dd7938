"""95th percentile of the latency of the window's calls, each from its start to its
return, on the host's clock.  A per-layer reading: the calls that the interpreter's full
garbage collections hold make this tail, so it swings with where in a pause each of them
falls, too widely to bound."""

UNIT = "ms"


def read(ctx):
    return ctx.window.latency_ms(95)
