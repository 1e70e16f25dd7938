"""Share of the window's certified batches that the light (one-pass) program served, in
per cent: the ``light_`` tiers of ``QueryProcessor.cert_tier_counts`` over all of them.
Batches the shape gate sent to the scan (``disengaged``) ran no certificate and count for
neither; a store without the light program records no ``light_`` tier and reads 0."""

UNIT = "%"
LIGHT = "light_"
NO_CERTIFICATE = "disengaged"


def read(ctx):
    tiers = {t: n for t, n in ctx.delta["tiers"].items()
             if t.removeprefix(LIGHT) != NO_CERTIFICATE}
    total = sum(tiers.values())
    if not total:
        return None
    return 100.0 * sum(n for t, n in tiers.items() if t.startswith(LIGHT)) / total
