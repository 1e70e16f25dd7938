"""State layer: vectors in device memory, namespaced, exactly searchable."""

from .vector import Vector
from .namespace import DeviceState, NamespaceStore
from .storage import StorageEngine
from .index import SearchIndex, SearchResult

__all__ = [
    "Vector",
    "DeviceState",
    "NamespaceStore",
    "StorageEngine",
    "SearchIndex",
    "SearchResult",
]
