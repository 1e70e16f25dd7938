"""Re-export of the filter mini-language (the implementation lives at the package's top
level so the store layer can use it without a store<->engine import cycle)."""

from ..filters import FilterMaskCache, filter_cache_key, matches_filter

__all__ = ["FilterMaskCache", "filter_cache_key", "matches_filter"]
