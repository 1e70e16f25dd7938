"""Mean wall per call of the program's ``knn_finish`` span: escalation of failed proofs
and the wider float64 settle, with their own copies, and the certificate tier's
record."""

UNIT = "ms"


def read(ctx):
    ms, n = ctx.delta["spans"].get("knn_finish", (0.0, 0))
    return ms / n if n else None
