"""Mean wall per call of ``QueryStats`` stage ``"device"``: ``_raw_search`` with its
copies back (host clock, not device time)."""

UNIT = "ms"


def read(ctx):
    ms, n = ctx.delta["stage"].get("device", (0.0, 0))
    return ms / n if n else None
