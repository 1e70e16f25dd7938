"""Share of the wall of the program's host-work spans in which their thread was off the
CPU, in per cent: 100 x (1 - summed thread CPU time / summed wall) over ``query.prepare``,
``knn_kernel``, ``knn_finish``, ``hydrate`` and ``query.cache_store``.  Off the CPU there
is waiting for the interpreter lock (held by another client, or by a collection another
client runs).  ``knn_upload`` and ``knn_fetch`` wait on the device too and are left out.
Reads the spans' ``<name>.cpu`` aggregates; a span without one counts for neither sum."""

UNIT = "%"
SPANS = ("query.prepare", "knn_kernel", "knn_finish", "hydrate", "query.cache_store")
CPU = ".cpu"


def read(ctx):
    spans = ctx.delta["spans"]
    timed = [s for s in SPANS if spans.get(s + CPU, (0.0, 0))[1]]
    wall = sum(spans[s][0] for s in timed)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - sum(spans[s + CPU][0] for s in timed) / wall)
