"""Mean wall per call of the program's ``hydrate`` span (result dicts built from the
snapshot's slot tables)."""

UNIT = "ms"


def read(ctx):
    ms, n = ctx.delta["spans"].get("hydrate", (0.0, 0))
    return ms / n if n else None
