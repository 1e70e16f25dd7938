"""Mean wall per call of the program's ``knn_fetch`` span: the one copy of the search's
result to the host, waiting for the device's queued work, and retaking the interpreter
lock."""

UNIT = "ms"


def read(ctx):
    ms, n = ctx.delta["spans"].get("knn_fetch", (0.0, 0))
    return ms / n if n else None
