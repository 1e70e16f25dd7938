"""Mean wall per call of the program's ``knn_kernel`` span: host issuing of the search
(phase 1, selection, rescan, settle, proof) up to the tensors ready for the copy back.
None in a program without a ``knn_fetch`` span, whose ``knn_kernel`` holds the copy too."""

UNIT = "ms"


def read(ctx):
    spans = ctx.delta["spans"]
    ms, n = spans.get("knn_kernel", (0.0, 0))
    return ms / n if n and spans.get("knn_fetch", (0.0, 0))[1] else None
