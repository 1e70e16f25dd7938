"""Mean wall per call of the program's ``sweep.rescan`` span, inside ``knn_kernel`` on the
certified sweep: the tier-1 window selection, issuing kernel B2 and the float64 settle."""

UNIT = "ms"


def read(ctx):
    ms, n = ctx.delta["spans"].get("sweep.rescan", (0.0, 0))
    return ms / n if n else None
