"""Device bytes of the namespace's store (``NamespaceStore.nbytes``, after the window)
over the user's vectors: live rows x dim x 4 bytes."""

UNIT = "B/B"


def read(ctx):
    s = ctx.store
    user = s["live"] * s["dim"] * 4
    return s["nbytes"] / user if user else None
