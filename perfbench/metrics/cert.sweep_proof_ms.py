"""Mean wall per call of the program's ``sweep.proof`` span, inside ``knn_kernel`` on the
certified sweep: the per-query certificate and the result that carries its escalation."""

UNIT = "ms"


def read(ctx):
    ms, n = ctx.delta["spans"].get("sweep.proof", (0.0, 0))
    return ms / n if n else None
