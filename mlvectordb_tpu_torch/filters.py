"""Metadata filters → per-slot bitmask predicates: the port's copy of
``mlvectordb_tpu/filters.py`` (numpy and the stdlib only; the port imports nothing of the
JAX package).

The reference README advertises a ``Filter`` parameter on search and metadata queries but
ships neither (SURVEY.md §0.1; reference interfaces take no filter —
src/mlvectordb/interfaces/index.py:12).  Here filters are first-class: a small Mongo-style
spec is evaluated over a namespace's metadata into a boolean mask aligned with the device
slots, cached per (namespace version, filter), and ANDed with the liveness mask inside the
search kernel — so a filtered ("hybrid") query costs the same one fused kernel pass.

Spec grammar (values compared with Python semantics):
    {"field": value}                         equality shorthand
    {"field": {"$eq"/"$ne"/"$gt"/"$gte"/"$lt"/"$lte": v}}
    {"field": {"$in"/"$nin": [v, ...]}}
    {"field": {"$exists": bool}}
    {"$and": [spec, ...]}  {"$or": [spec, ...]}  {"$not": spec}
Nested fields via dotted paths: {"a.b": 1}.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import numpy as np

_OPS = {"$eq", "$ne", "$gt", "$gte", "$lt", "$lte", "$in", "$nin", "$exists"}
_MISSING = object()


def _lookup(meta: Dict[str, Any], path: str):
    cur: Any = meta
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return _MISSING
        cur = cur[part]
    return cur


def _cmp(val, op: str, arg) -> bool:
    if op == "$exists":
        return (val is not _MISSING) == bool(arg)
    if val is _MISSING:
        return op in ("$ne", "$nin")
    try:
        if op == "$eq":
            return val == arg
        if op == "$ne":
            return val != arg
        if op == "$gt":
            return val > arg
        if op == "$gte":
            return val >= arg
        if op == "$lt":
            return val < arg
        if op == "$lte":
            return val <= arg
        if op == "$in":
            return val in arg
        if op == "$nin":
            return val not in arg
    except TypeError:
        return False
    raise ValueError(f"unknown filter operator {op!r}")


def matches_filter(meta: Dict[str, Any], spec: Optional[Dict[str, Any]]) -> bool:
    """True iff the metadata dict satisfies the filter spec."""
    if not spec:
        return True
    for key, cond in spec.items():
        if key == "$and":
            if not all(matches_filter(meta, s) for s in cond):
                return False
        elif key == "$or":
            if not any(matches_filter(meta, s) for s in cond):
                return False
        elif key == "$not":
            if matches_filter(meta, cond):
                return False
        elif key.startswith("$"):
            raise ValueError(f"unknown filter operator {key!r}")
        else:
            val = _lookup(meta, key)
            if isinstance(cond, dict) and cond and any(k.startswith("$") for k in cond):
                bad = [k for k in cond if k not in _OPS]
                if bad:
                    raise ValueError(f"unknown filter operator {bad[0]!r}")
                if not all(_cmp(val, op, arg) for op, arg in cond.items()):
                    return False
            else:
                if val is _MISSING or val != cond:
                    return False
    return True


def filter_cache_key(spec: Dict[str, Any]) -> str:
    return json.dumps(spec, sort_keys=True, default=str)


class FilterMaskCache:
    """Compiles filter specs to slot-aligned boolean masks, invalidated by store version."""

    def __init__(self, max_entries: int = 64):
        self._cache: Dict[Tuple[str, str, int, int], np.ndarray] = {}
        self._max = max_entries

    def mask_for(self, ns_store, spec: Dict[str, Any]) -> np.ndarray:
        """[capacity] bool mask of slots whose metadata matches the spec.

        (Callers AND this with the liveness mask, so dead slots may carry either value.)
        Uses the native C++ columnar evaluator when the store has one — ~1000x the
        pure-Python dict walk at million-row scale; falls back to Python per-slot
        evaluation otherwise (and for specs the native grammar can't encode).
        """
        # incarnation guards against a GC'd-and-recreated namespace reusing (name,
        # version): the dead incarnation's mask must never be served to the new store
        key = (
            ns_store.name, getattr(ns_store, "incarnation", ""),
            filter_cache_key(spec), ns_store.version, ns_store.capacity,
        )
        hit = self._cache.get(key)
        if hit is not None:
            return hit

        mask = None
        mc = getattr(ns_store, "meta_columns", None)
        if mc is not None:
            try:
                mask = mc.eval(spec, ns_store.capacity)
            except (TypeError, ValueError):
                mask = None
        if mask is None:
            # Python fallback — also re-raises unknown-operator errors eagerly
            mask = np.zeros((ns_store.capacity,), bool)
            for slot, _vid, meta in ns_store.iter_slots():
                if matches_filter(meta or {}, spec):
                    mask[slot] = True
        else:
            # native parse failure (eval returned None handled above); unknown operators
            # must still raise like the Python path does
            _validate_spec_ops(spec)

        if len(self._cache) >= self._max:
            self._cache.clear()
        self._cache[key] = mask
        return mask


def _validate_spec_ops(spec: Any) -> None:
    """Raise ValueError on unknown $operators (parity with matches_filter)."""
    if not isinstance(spec, dict):
        return
    for key, cond in spec.items():
        if key in ("$and", "$or"):
            for s in cond:
                _validate_spec_ops(s)
        elif key == "$not":
            _validate_spec_ops(cond)
        elif key.startswith("$"):
            raise ValueError(f"unknown filter operator {key!r}")
        elif isinstance(cond, dict) and cond and any(k.startswith("$") for k in cond):
            bad = [k for k in cond if k not in _OPS]
            if bad:
                raise ValueError(f"unknown filter operator {bad[0]!r}")
