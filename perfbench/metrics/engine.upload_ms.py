"""Mean wall per call of the program's ``knn_upload`` span: padding the queries and their
copy to the device (a pageable copy, which waits for the work queued ahead of it on the
stream)."""

UNIT = "ms"


def read(ctx):
    ms, n = ctx.delta["spans"].get("knn_upload", (0.0, 0))
    return ms / n if n else None
