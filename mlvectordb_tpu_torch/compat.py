"""Drop-in compatibility layer for code written against the reference package: the
counterpart of ``mlvectordb_tpu/compat.py``.

The reference's public API (reference: src/mlvectordb/__init__.py:11-29) exposes
``Vector``, ``VectorDTO``, ``StorageEngineInMemory``, ``Index`` and ``QueryProcessor``
(constructed as ``QueryProcessor(storage, index)`` — server.py:54), plus the README's
``SimpleVector``.  This module re-exports the port's equivalents under those names, with a
QueryProcessor that takes the reference's two-argument constructor, so

    from mlvectordb_tpu_torch.compat import Index, QueryProcessor, StorageEngineInMemory
    qproc = QueryProcessor(StorageEngineInMemory(), Index())

works unchanged (on the card; pass ``device="cpu"`` to each for the CPU).  The "index" and
the "storage" are one device structure: the shim takes the Index's configuration (its
default metric) and serves the storage engine.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .config import DEFAULT_CONFIG, EngineConfig
from .engine.query_processor import QueryProcessor as _QueryProcessor
from .interfaces.vector import VectorDTO
from .store.index import SearchIndex as Index, SearchResult
from .store.storage import StorageEngine as StorageEngineInMemory
from .store.vector import Vector

# README's Quick Start uses SimpleVector with the same shape as Vector
SimpleVector = Vector


class QueryProcessor(_QueryProcessor):
    """Accepts the reference's (storage, index) pair or the native (storage, config)."""

    def __init__(self, storage=None, index=None, config: Optional[EngineConfig] = None, *,
                 device="cuda"):
        if config is None:
            # inherit the Index's config (metric default / rebuild threshold) if given
            config = getattr(index, "config", None) or getattr(storage, "config",
                                                               DEFAULT_CONFIG)
            if index is not None and getattr(index, "_space", None):
                config = dataclasses.replace(config, default_metric=index._space)
        super().__init__(config, device=device, storage=storage)


__all__ = [
    "Vector",
    "SimpleVector",
    "VectorDTO",
    "StorageEngineInMemory",
    "Index",
    "SearchResult",
    "QueryProcessor",
]
