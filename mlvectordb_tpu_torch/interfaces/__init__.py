"""Contract layer: the protocols every component types against (copies of the JAX
package's ``interfaces/``, which are framework-free)."""

from .vector import VectorDTO, VectorProtocol
from .index import SearchResultProtocol, SearchIndexProtocol
from .storage_engine import StorageEngineProtocol
from .query_processor import QueryProcessorProtocol

__all__ = [
    "VectorDTO",
    "VectorProtocol",
    "SearchResultProtocol",
    "SearchIndexProtocol",
    "StorageEngineProtocol",
    "QueryProcessorProtocol",
]
