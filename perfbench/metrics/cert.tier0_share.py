"""Share of the window's batches that the first proof certified (tier 0, light or
heavy), from ``QueryProcessor.cert_tier_counts``."""

UNIT = "%"
TIER0 = ("fast", "light_fast")


def read(ctx):
    tiers = ctx.delta["tiers"]
    total = sum(tiers.values())
    if not total:
        return None
    return 100.0 * sum(tiers.get(t, 0) for t in TIER0) / total
