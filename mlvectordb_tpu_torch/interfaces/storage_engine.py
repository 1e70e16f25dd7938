"""Storage-engine contract (a copy of ``mlvectordb_tpu/interfaces/storage_engine.py``).

Capability parity: reference src/mlvectordb/interfaces/storage_engine.py:15-53
(write / write_vectors / read / read_vectors / delete / exists / clear_all /
get_storage_info / namespace_map / delete_namespace / list_namespaces, plus the
storage_size / total_vectors / namespace properties).  Extended with the README-advertised
``query_by_metadata`` / ``iterate_vectors`` that the reference never implemented
(SURVEY.md §0.1).
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, Iterable, Iterator, List, Optional, Protocol, Sequence, runtime_checkable

from .vector import VectorProtocol


@runtime_checkable
class StorageEngineProtocol(Protocol):
    @property
    def storage_size(self) -> int: ...

    @property
    def total_vectors(self) -> int: ...

    def write(self, vector: VectorProtocol, namespace: str = "default") -> None: ...

    def write_vectors(self, vectors: Sequence[VectorProtocol], namespace: str = "default") -> None: ...

    def read(self, vector_id: uuid.UUID, namespace: str = "default") -> Optional[VectorProtocol]: ...

    def read_vectors(
        self, vector_ids: Iterable[uuid.UUID], namespace: str = "default"
    ) -> List[Optional[VectorProtocol]]: ...

    def delete(self, vector_id: uuid.UUID, namespace: str = "default") -> bool: ...

    def exists(self, vector_id: uuid.UUID) -> bool: ...

    def clear_all(self) -> None: ...

    def get_storage_info(self) -> Dict[str, Any]: ...

    @property
    def namespace_map(self) -> Dict[str, List[VectorProtocol]]: ...

    def delete_namespace(self, namespace: str) -> bool: ...

    def list_namespaces(self) -> List[str]: ...

    def query_by_metadata(self, filter: Dict[str, Any], namespace: str = "default") -> List[VectorProtocol]: ...

    def iterate_vectors(self, namespace: str = "default") -> Iterator[VectorProtocol]: ...
