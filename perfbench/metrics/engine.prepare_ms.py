"""Mean wall per call of the program's ``query.prepare`` span: stacking the call's query
objects, the result cache's key (a blake2b over the queries) and its lookup."""

UNIT = "ms"


def read(ctx):
    ms, n = ctx.delta["spans"].get("query.prepare", (0.0, 0))
    return ms / n if n else None
