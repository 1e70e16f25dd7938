"""Namespaced storage engine: the counterpart of ``mlvectordb_tpu/store/storage.py``.

The StorageEngine protocol surface of the reference's in-memory engine
(reference: src/mlvectordb/implementations/storage_engine_in_memory.py:11-86) with the
same observable semantics (delete garbage-collects an emptied namespace; exists scans all
namespaces; read of a missing id returns None), and ``query_by_metadata`` over the
native metadata columns where they exist.
"""

from __future__ import annotations

import threading
import uuid as uuid_mod
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import torch

from ..config import DEFAULT_CONFIG, EngineConfig
from ..filters import _validate_spec_ops, matches_filter
from .namespace import NamespaceStore, check_supported
from .vector import Vector


class StorageEngine:
    """Dict of NamespaceStores; all vector payloads live on ``device``."""

    def __init__(self, config: EngineConfig = DEFAULT_CONFIG, *, device="cuda"):
        check_supported(config)
        self.config = config
        self.device = torch.device(device)
        self._namespaces: Dict[str, NamespaceStore] = {}
        self._lock = threading.RLock()

    # ------------------------------------------------------------------ namespaces

    def namespace(self, name: str, create: bool = False) -> Optional[NamespaceStore]:
        ns = self._namespaces.get(name)
        if ns is None and create:
            with self._lock:
                ns = self._namespaces.get(name)
                if ns is None:
                    ns = NamespaceStore(name, self.config, device=self.device)
                    self._namespaces[name] = ns
        return ns

    def attach(self, ns: NamespaceStore) -> None:
        """Serve an already-built store (e.g. from ``convert.store_from_jax_snapshot``)
        under its name; the name must be free."""
        if ns.device != self.device:
            raise ValueError(f"store lives on {ns.device}, engine on {self.device}")
        with self._lock:
            if ns.name in self._namespaces:
                raise ValueError(f"namespace {ns.name!r} already exists")
            self._namespaces[ns.name] = ns

    def list_namespaces(self) -> List[str]:
        return list(self._namespaces.keys())

    def delete_namespace(self, namespace: str) -> bool:
        with self._lock:
            return self._namespaces.pop(namespace, None) is not None

    @property
    def namespace_map(self) -> Dict[str, List[Vector]]:
        return {name: ns.all_vectors() for name, ns in self._namespaces.items()}

    # ------------------------------------------------------------------ writes

    def write(self, vector: Vector, namespace: str = "default") -> None:
        self.namespace(namespace, create=True).upsert([vector])

    def write_vectors(self, vectors: Sequence[Vector], namespace: str = "default") -> None:
        if vectors:
            self.namespace(namespace, create=True).upsert(list(vectors))

    def check_write(self, dims: Sequence[int], ids: Sequence[uuid_mod.UUID],
                    namespace: str = "default") -> None:
        """Raise what writing rows of these dims and ids to ``namespace`` would raise,
        changing nothing (a missing namespace is checked as a fresh one, not created)."""
        ns = self._namespaces.get(namespace)
        if ns is None:
            ns = NamespaceStore(namespace, self.config, device=self.device)
        ns.check_write(dims, ids)

    def delete(self, vector_id: uuid_mod.UUID, namespace: str = "default") -> bool:
        return bool(self.delete_vectors([vector_id], namespace))

    def delete_vectors(
        self, vector_ids: Iterable[uuid_mod.UUID], namespace: str = "default"
    ) -> List[uuid_mod.UUID]:
        ns = self._namespaces.get(namespace)
        if ns is None:
            return []
        removed = ns.delete(list(vector_ids))
        # empty-namespace GC, matching reference delete semantics
        # (storage_engine_in_memory.py:49-50)
        if removed and ns.live_count == 0:
            with self._lock:
                if ns.live_count == 0:
                    self._namespaces.pop(namespace, None)
        return removed

    def clear_all(self) -> None:
        with self._lock:
            self._namespaces.clear()

    # ------------------------------------------------------------------ reads

    def read(self, vector_id: uuid_mod.UUID, namespace: str = "default") -> Optional[Vector]:
        ns = self._namespaces.get(namespace)
        return ns.get(vector_id) if ns else None

    def read_vectors(
        self, vector_ids: Iterable[uuid_mod.UUID], namespace: str = "default"
    ) -> List[Optional[Vector]]:
        ns = self._namespaces.get(namespace)
        if ns is None:
            return [None for _ in vector_ids]
        return [ns.get(vid) for vid in vector_ids]

    def exists(self, vector_id: uuid_mod.UUID) -> bool:
        return any(ns.contains(vector_id) for ns in self._namespaces.values())

    def query_by_metadata(
        self, filter: Dict[str, Any], namespace: str = "default"
    ) -> List[Vector]:
        """The live vectors whose metadata match ``filter``, in slot-map order: the native
        mask where the namespace has metadata columns (unknown operators still raise),
        the Python evaluator otherwise."""
        ns = self._namespaces.get(namespace)
        if ns is None:
            return []
        mc = ns.meta_columns
        if mc is not None:
            try:
                mask = mc.eval(filter, ns.capacity)
            except (TypeError, ValueError):
                mask = None
            if mask is not None:
                _validate_spec_ops(filter)
                return [ns._vector_at(slot, vid)
                        for slot, vid, _meta in ns.iter_slots() if mask[slot]]
        return [ns._vector_at(slot, vid)
                for slot, vid, meta in ns.iter_slots() if matches_filter(meta or {}, filter)]

    def iterate_vectors(self, namespace: str = "default") -> Iterator[Vector]:
        ns = self._namespaces.get(namespace)
        if ns is None:
            return iter(())
        return iter(ns.all_vectors())

    # ------------------------------------------------------------------ stats

    @property
    def total_vectors(self) -> int:
        return sum(ns.live_count for ns in self._namespaces.values())

    @property
    def storage_size(self) -> int:
        return sum(ns.nbytes for ns in self._namespaces.values())

    def get_storage_info(self) -> Dict[str, Any]:
        # same shape as the reference (storage_engine_in_memory.py:61-69), extended with
        # the device, the offloaded namespaces and, on CUDA, the allocator's counters
        per_ns = {name: ns.live_count for name, ns in self._namespaces.items()}
        info = {
            "storage_type": f"torch_{self.device.type}",
            "device": str(self.device),
            "total_vectors": self.total_vectors,
            "storage_size_bytes": self.storage_size,
            "namespaces": list(self._namespaces.keys()),
            "vectors_per_namespace": per_ns,
            "namespace_count": len(self._namespaces),
            "offloaded_namespaces": [
                name for name, ns in self._namespaces.items() if ns.offloaded
            ],
        }
        if self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            info["device_memory"] = {
                "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                "bytes_limit": torch.cuda.get_device_properties(self.device).total_memory,
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
                "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
            }
        return info
