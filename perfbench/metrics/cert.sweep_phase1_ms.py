"""Mean wall per call of the program's ``sweep.phase1`` span, inside ``knn_kernel`` on the
certified sweep: folding the query and its error terms, and issuing kernel B1."""

UNIT = "ms"


def read(ctx):
    ms, n = ctx.delta["spans"].get("sweep.phase1", (0.0, 0))
    return ms / n if n else None
