"""State carried across from the JAX package.

``store_from_jax_snapshot`` builds a torch ``NamespaceStore`` from the dict that the JAX
``NamespaceStore.snapshot_arrays()`` returns (numpy values, string ids, metadata), through
``bulk_upsert`` as the JAX ``load_snapshot`` does.  Data plays the role of weights here:
a namespace served by the JAX package can be served by this one with the same ids.
"""

from __future__ import annotations

import uuid as uuid_mod
from typing import Any, Dict

import numpy as np

from .config import EngineConfig
from .store.namespace import NamespaceStore


def store_from_jax_snapshot(snap: Dict[str, Any], config: EngineConfig, device) -> NamespaceStore:
    ns = NamespaceStore(snap["name"], config, device=device)
    if len(snap["ids"]):
        ns.bulk_upsert(
            np.asarray(snap["values"], np.float32),
            [uuid_mod.UUID(x) for x in snap["ids"]],
            snap["metadata"],
        )
    elif snap.get("dim"):
        ns._ensure_dim(int(snap["dim"]))
    return ns
