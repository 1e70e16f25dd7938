"""Query engine: the write/read/search paths."""

from .query_processor import QueryProcessor

__all__ = ["QueryProcessor"]
