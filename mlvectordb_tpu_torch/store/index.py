"""SearchIndex: the counterpart of ``mlvectordb_tpu/store/index.py``.

The IndexProtocol view over the device store (reference:
src/mlvectordb/implementations/index.py:18-165 — add / remove / search / rebuild per
namespace, plus is_rebuild_required), for users who program against the index
abstraction rather than the QueryProcessor.  There is no separate graph to maintain: the
class is a thin view over NamespaceStores and the row-major exact-kNN path, so the index
never drifts from storage.  Unlike the reference's rebuild, which clears every
namespace's bookkeeping, ``rebuild`` compacts only the namespace asked for.
"""

from __future__ import annotations

import dataclasses
import uuid as uuid_mod
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, HIGHER_IS_BETTER, EngineConfig, canonical_metric
from ..filters import FilterMaskCache
from ..ops.backend import knn_backend
from ..ops.distances import MASKED
from .namespace import NamespaceStore
from .vector import Vector


@dataclasses.dataclass
class SearchResult:
    """Parity with reference index.py:11-14."""

    vector_id: uuid_mod.UUID
    score: float


class SearchIndex:
    """Per-namespace exact search over stores on ``device`` (IndexProtocol)."""

    def __init__(
        self,
        space: str = "l2",
        config: EngineConfig = DEFAULT_CONFIG,
        rebuild_threshold: Optional[float] = None,
        *,
        device="cuda",
    ):
        # `space` sets the DEFAULT metric like the reference's constructor, but a metric
        # passed to search() selects the distance function
        self._space = canonical_metric(space)
        if rebuild_threshold is not None:
            config = dataclasses.replace(config, rebuild_threshold=rebuild_threshold)
        self.config = config
        self.device = torch.device(device)
        self._namespaces: Dict[str, NamespaceStore] = {}
        self._filter_masks = FilterMaskCache()

    # ------------------------------------------------------------------ protocol

    def add(self, vectors: Sequence[Vector], namespace: str = "default") -> None:
        if not vectors:
            return
        ns = self._namespaces.get(namespace)
        if ns is None:
            ns = NamespaceStore(namespace, self.config, device=self.device)
            self._namespaces[namespace] = ns
        ns.upsert(list(vectors))

    def remove(self, vector_ids: Iterable[uuid_mod.UUID], namespace: str = "default") -> None:
        ns = self._namespaces.get(namespace)
        if ns is not None:
            ns.delete(list(vector_ids))

    def search(
        self,
        query,
        k: int,
        namespace: str = "default",
        metric: Optional[str] = None,
        filter: Optional[Dict] = None,
    ) -> List[SearchResult]:
        """``filter``: an optional metadata predicate (filters.py)."""
        ns = self._namespaces.get(namespace)
        if ns is None or ns.live_count == 0 or k <= 0:
            return []  # missing namespace -> [] (reference index.py:98-99)
        m = canonical_metric(metric or self._space)
        q = np.asarray(query.values if hasattr(query, "values") else query,
                       np.float32).reshape(-1)
        if q.shape[0] != ns.dim:
            raise ValueError(f"query dim {q.shape[0]} != namespace dim {ns.dim}")
        k_eff = min(k, ns.live_count)  # clamp (reference index.py:103-107)
        kb = min(self.config.bucket_k(k_eff), ns.capacity)
        q_pad = np.zeros((self.config.bucket_batch(1), ns.dpad), np.float32)
        q_pad[0, : ns.dim] = q

        state = ns.device_state()
        valid = state.valid
        live_prefix = state.high_water if state.live_count == state.high_water else None
        if filter:
            mask = self._filter_masks.mask_for(ns, filter)
            valid = valid & torch.from_numpy(mask).to(valid.device)
            live_prefix = None
        dist, idx = knn_backend(self.config)(
            torch.from_numpy(q_pad).to(self.device), state.data, valid, state.sq_norms,
            k=kb, metric=m, db_tile=self.config.db_tile, live_prefix=live_prefix, n_live=1,
        )
        dist = dist[0, :k_eff].cpu().numpy()
        idx = idx[0, :k_eff].cpu().numpy()
        out = []
        for d, slot in zip(dist.tolist(), idx.tolist()):
            if d >= float(MASKED) / 2:  # masked filler (fewer matches than k)
                continue
            vid = ns.slot_to_id(int(slot))
            if vid is None:
                continue
            # score convention parity (reference index.py:121-128)
            out.append(SearchResult(vid, 1.0 - d if HIGHER_IS_BETTER[m] else d))
        return out

    def rebuild(self, namespace: Optional[str] = None, **_ignored) -> None:
        """Compact tombstones, per namespace only; None compacts every namespace on its
        own (no cross-namespace wipes)."""
        for name in [namespace] if namespace else list(self._namespaces):
            ns = self._namespaces.get(name)
            if ns is not None:
                ns.compact()

    def is_rebuild_required(self, namespace: str = "default") -> bool:
        ns = self._namespaces.get(namespace)
        return bool(ns and ns.rebuild_required())
