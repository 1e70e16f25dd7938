"""Mean wall per call of the program's ``query.cache_store`` span: the result cache's copy
of the call's result dicts and its LRU insert."""

UNIT = "ms"


def read(ctx):
    ms, n = ctx.delta["spans"].get("query.cache_store", (0.0, 0))
    return ms / n if n else None
