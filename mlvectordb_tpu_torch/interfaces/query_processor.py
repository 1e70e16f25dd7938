"""Query-processor contract (a copy of ``mlvectordb_tpu/interfaces/query_processor.py``).

Capability parity: reference src/mlvectordb/interfaces/query_processor.py:7-11
(insert / upsert_many / find_similar / delete, namespace defaulting to "default").
Widened to the README-documented query surface the reference never shipped
(range search, similarity threshold, metadata filter, hybrid — SURVEY.md §0.1).
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, Iterable, List, Optional, Protocol, Sequence

from .vector import VectorDTO, VectorProtocol


class QueryProcessorProtocol(Protocol):
    def insert(self, vector: VectorDTO, namespace: str = "default") -> VectorProtocol: ...

    def upsert_many(
        self, vectors: Sequence[VectorDTO], namespace: str = "default"
    ) -> List[VectorProtocol]: ...

    def find_similar(
        self,
        query: VectorDTO,
        top_k: int = 10,
        namespace: str = "default",
        metric: Optional[str] = None,
        filter: Optional[Dict[str, Any]] = None,
    ) -> List[Dict[str, Any]]: ...

    def range_search(
        self,
        query: VectorDTO,
        radius: float,
        namespace: str = "default",
        metric: Optional[str] = None,
        filter: Optional[Dict[str, Any]] = None,
        limit: int = 1000,
    ) -> List[Dict[str, Any]]: ...

    def delete(self, vector_ids: Iterable[uuid.UUID], namespace: str = "default") -> List[uuid.UUID]: ...
