"""Query engine: the counterpart of ``mlvectordb_tpu/engine/query_processor.py``.

The ported slice: insert / upsert_many / bulk_load / delete / delete_namespace, exact
batched search with hydration and the result cache, range / similarity search, metadata
filters on every search (hybrid search) and ``query_by_metadata``, on the row-major path
or, with a ``sweep_dtype`` ("bfloat16", "int8" or "float32"), the certified sweep with
its certificate-tier counters and, for a bf16 mirror, the per-namespace light -> heavy
dispatch.  A filter's mask (native columnar evaluator where it builds) is ANDed into the
liveness mask of one snapshot, and its search prep is scoped inside that snapshot's prep
dict.  Hydration runs in the native ``_hydrate`` extension where it builds.  Reference
behaviors kept:
  * k clamped to the live count (index.py:103-107)
  * search of a missing namespace returns [] (index.py:98-99)
  * result dicts {id, values, metadata, score}, silently dropping hits that vanished from
    storage between select and hydrate (query_processor.py:38-49)
  * score convention: l2/ip -> raw distance (lower better), cosine -> similarity = 1 - dist
    (index.py:121-128)

Not ported yet: IVF (A13), the WAL and snapshots (A20), explain and statistics (A7).
``nprobe=`` raises.
"""

from __future__ import annotations

import hashlib
import threading
import uuid as uuid_mod
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, HIGHER_IS_BETTER, EngineConfig, canonical_metric
from ..filters import filter_cache_key
from ..interfaces.vector import VectorDTO
from ..ops.backend import knn_backend
from ..ops.distances import MASKED
from ..ops.fused_knn_t import SweepResult, fetch
from ..store.storage import StorageEngine
from ..store.vector import Vector
from ..utils.tracing import trace_span
from .filters import FilterMaskCache

# filter-scoped prep dicts one snapshot keeps; past that a search gets a throwaway dict
_FILTER_SCOPES = 32


def _hydrate_native():
    """The native row-hydration extension, or None (pure-Python fallback)."""
    from ..native import hydrate_module

    return hydrate_module()


def _upload_mask(mask: np.ndarray, device) -> torch.Tensor:
    """A filter's [capacity] bool mask on the device: one host->device copy of capacity
    bytes, made once per (snapshot, filter).  Not counted in ``transfer_counts``, which
    count the query and the result as the JAX package does."""
    return torch.from_numpy(mask).to(device)


class QueryProcessor:
    """Composes the device store with the fused search kernels."""

    def __init__(
        self,
        config: EngineConfig = DEFAULT_CONFIG,
        *,
        device,
    ):
        self.config = config
        self.device = torch.device(device)
        self.storage = StorageEngine(config, device=self.device)
        self._filter_masks = FilterMaskCache()
        self._write_lock = threading.RLock()  # single-writer discipline
        # query-result cache, keyed by namespace VERSION (any mutation invalidates
        # implicitly); stores the final hydrated result lists, LRU-evicted
        self._result_cache: "OrderedDict[Any, List[List[Dict[str, Any]]]]" = OrderedDict()
        self._result_cache_hits = 0
        self._result_cache_lock = threading.Lock()
        # host<->device transfer audit counters: the serving path does exactly ONE
        # host->device (the query batch) and ONE device->host ((dist, idx) fetched
        # together, with the per-query proof on the certified sweep) per search; an
        # escalation after a failed proof adds its own counted copies
        self.transfer_counts = {"h2d": 0, "d2h": 0}
        # certified sweep: tier counts per namespace, and the light/heavy dispatch mode
        # per (namespace, metric, masked variant)
        self._cert_lock = threading.Lock()
        self._cert_tiers: Dict[str, Dict[str, int]] = {}
        self._cert_mode: Dict[Any, str] = {}

    def _result_cache_key(self, q_np, top_k, namespace, metric, filter=None):
        ns = self.storage.namespace(namespace)
        if ns is None or self.config.result_cache_size <= 0:
            return None
        h = hashlib.blake2b(q_np.tobytes(), digest_size=16).hexdigest()
        fk = filter_cache_key(filter) if filter else ""
        # ns.incarnation: version counters restart at 0 when a namespace is GC'd and
        # recreated, so (name, version) alone can resurrect a dead incarnation's results
        return (namespace, ns.incarnation, ns.version, h, top_k, metric, fk)

    # ------------------------------------------------------------------ writes

    def insert(self, vector: VectorDTO, namespace: str = "default") -> Vector:
        with self._write_lock:
            v = Vector(vector.values, vector.metadata, id=vector.id)
            self.storage.write(v, namespace)
            return v

    def upsert_many(
        self, vectors: Sequence[VectorDTO], namespace: str = "default"
    ) -> List[Vector]:
        """True upsert: DTOs carrying an id overwrite in place; id-less DTOs mint uuid4."""
        with self._write_lock, trace_span("upsert", namespace=namespace, count=len(vectors)):
            vs = [Vector(d.values, d.metadata, id=d.id) for d in vectors]
            self.storage.write_vectors(vs, namespace)
            return vs

    def delete(
        self, vector_ids: Iterable[uuid_mod.UUID], namespace: str = "default"
    ) -> List[uuid_mod.UUID]:
        with self._write_lock, trace_span("delete", namespace=namespace):
            return self.storage.delete_vectors(list(vector_ids), namespace)

    def delete_namespace(self, namespace: str) -> bool:
        with self._write_lock:
            return self.storage.delete_namespace(namespace)

    def bulk_load(
        self,
        values,                              # [n, dim] array-like
        namespace: str = "default",
        ids=None,
        metadatas=None,
        batch_rows: int = 65536,
    ):
        """High-throughput vectorized ingestion (no per-vector Python objects).

        Returns the list of uuids.  Batches bound peak host memory and the size of each
        device scatter.
        """
        values = np.ascontiguousarray(values, np.float32)
        n = values.shape[0]
        out = []
        with self._write_lock, trace_span("bulk_load", namespace=namespace, count=n):
            ns = self.storage.namespace(namespace, create=True)
            for lo in range(0, n, batch_rows):
                hi = min(lo + batch_rows, n)
                out.extend(ns.bulk_upsert(
                    values[lo:hi],
                    ids[lo:hi] if ids is not None else None,
                    metadatas[lo:hi] if metadatas is not None else None,
                ))
        return out

    # ------------------------------------------------------------------ search core

    def _raw_search(self, q_np: np.ndarray, namespace: str, k: int, metric: str,
                    filter: Optional[Dict[str, Any]] = None):
        """Returns (dist [B, k'] np, slots [B, k'] np, ns_store, tables) with
        k' = min(k, live); tables is the snapshot's host slot tables (one generation,
        for torn-free hydration).  Empty namespace / k<=0 -> (None, None, None, None)."""
        ns = self.storage.namespace(namespace)
        if ns is None or ns.live_count == 0 or k <= 0:
            return None, None, None, None
        if q_np.shape[1] != ns.dim:
            raise ValueError(
                f"query dim {q_np.shape[1]} != namespace {namespace!r} dim {ns.dim}"
            )
        # Snapshot read with an RCU-style retry: a published DeviceState is never
        # mutated, but a filter's mask is built from the live host tables, so a
        # republish before the mask build, or a capacity or version that moves during
        # it, raises "snapshot deleted" and the search re-snapshots.  The last attempt
        # holds the namespace lock throughout, so it always makes progress.
        attempts = 6
        for attempt in range(attempts):
            try:
                if attempt == attempts - 1:
                    with ns._lock:
                        return self._search_snapshot(q_np, ns, namespace, k, metric, filter)
                return self._search_snapshot(q_np, ns, namespace, k, metric, filter)
            except RuntimeError as e:
                if "deleted" not in str(e):
                    raise
        raise RuntimeError("unreachable")  # pragma: no cover

    def _filter_scope(self, state, mask: np.ndarray, spec: Dict[str, Any]):
        """(valid & mask on the device, the filter's prep dict) for one snapshot.

        Masked prep (and the zero-query column of the padded rows) depends on the
        filtered liveness, so it is scoped INSIDE the snapshot's own prep dict under
        ("filter", key): it lives and dies with the snapshot's arrays, and an unfiltered
        or other-filter search of the same snapshot never reads it.  The device form of
        valid & mask is kept in the same dict, so a repeated filter uploads its mask
        once per snapshot.  Bounded: past _FILTER_SCOPES entries a search gets a
        throwaway dict instead of pinning device memory for the snapshot's lifetime."""
        fk = ("filter", filter_cache_key(spec))
        if fk in state.prep_cache or len(state.prep_cache) < _FILTER_SCOPES:
            scope = state.prep_cache.setdefault(fk, {})
        else:
            scope = {}
        valid = scope.get("valid")
        if valid is None:
            valid = state.valid & _upload_mask(mask, state.valid.device)
            scope["valid"] = valid  # GIL-atomic; a racing reader uploads its own
        return valid, scope

    def _search_snapshot(self, q_np, ns, namespace, k, metric, filter=None):
        v0 = ns.version            # read BEFORE the snapshot: brackets the mask build
        state = ns.device_state()  # snapshot: writers replace tensors, never mutate them
        valid, prep_cache = state.valid, state.prep_cache
        if filter:
            # Writers mutate the host tables and metadata columns, bump the version and
            # publish under the namespace lock; a compaction bumps the version BEFORE it
            # rebuilds the tables, so a mask built without the lock could come from a
            # half-rebuilt layout and pass the version check.  Under the lock, the
            # tables are those of the published snapshot, which must be ours.
            with ns._lock:
                if ns._state is not state:
                    raise RuntimeError("snapshot deleted (republished before the mask build)")
                with trace_span("filter_mask", namespace=namespace):
                    mask = self._filter_masks.mask_for(ns, filter)
            if mask.shape[0] != state.valid.shape[0]:  # capacity changed mid-snapshot
                raise RuntimeError("snapshot deleted (capacity changed)")
            if ns.version != v0:
                # a write published between the version read and the mask build: the
                # mask (live tables, keyed by the live version) may not match the
                # snapshot's arrays, so re-snapshot
                raise RuntimeError("snapshot deleted (version moved during mask build)")
            valid, prep_cache = self._filter_scope(state, mask, filter)
        # counters come from the SNAPSHOT, never the live store attributes: a concurrent
        # upsert bumps host tables before publishing the scattered arrays, and pairing
        # old data with the new high-water would admit never-written all-zero rows
        k_eff = min(k, state.live_count)
        B = q_np.shape[0]
        if k_eff <= 0:
            empty = np.zeros((B, 0))
            return empty, empty.astype(np.int32), ns, state.host_tables
        kb = min(self.config.bucket_k(k_eff), state.valid.shape[0])
        Bb = self.config.bucket_batch(B)
        q_pad = np.zeros((Bb, ns.dpad), np.float32)
        q_pad[:B, : ns.dim] = q_np

        self.transfer_counts["h2d"] += 1
        q_dev = torch.from_numpy(q_pad).to(self.device)
        # rows [0, high_water) are exactly the live rows iff no slot below the
        # high-water mark is dead and no filter is active => the fast kernel can skip all
        # mask traffic
        live_prefix = None
        if not filter and state.live_count == state.high_water:
            live_prefix = state.high_water
        backend = knn_backend(self.config)
        # request the certificate tier on certified configs: it rides in the SAME copy
        want_tier = bool(self.config.certify_exact) and state.mirror is not None
        masked = live_prefix is None
        use_light = self._use_light(namespace, state, metric, masked=masked)
        with trace_span("knn_kernel", namespace=namespace, k=kb, batch=Bb):
            out = backend(
                q_dev, state.data, valid, state.sq_norms,
                k=kb, metric=metric, db_tile=self.config.db_tile, live_prefix=live_prefix,
                report_tier=want_tier, mirror=state.mirror, sweep_err=state.sweep_err,
                sweep_resid=state.sweep_resid, sweep_rscale=state.sweep_rscale,
                sweep_err1=state.sweep_err1, sweep_rscale2=state.sweep_rscale2,
                sweep_light=use_light,
                sweep_prep=prep_cache, sweep_defer=True, n_live=B,
            )
            if isinstance(out, SweepResult):
                # ONE device->host transfer: the int32 ids travel bit-cast beside the
                # f32 distances, and the per-query proof beside them
                parts = (out.dist, out.idx) + (() if out.okq is None else (out.okq,))
            else:
                parts = out[:2]
            self.transfer_counts["d2h"] += 1
            host = fetch(*parts)
        dist, idx = host[0], host[1]
        if isinstance(out, SweepResult):
            tier = out.tier
            if out.okq is not None and not host[2].all():
                # a proof failed: the escalation's own copies are counted through fetch
                dist, idx, tier = out.escalate(host[2], self._counted_fetch)
            self._record_cert_tier(namespace, tier, light=use_light)
            if use_light and tier == 2:
                # the light band is too wide for this corpus: switch this (namespace,
                # metric, variant) to the heavy program.  Eager torch compiles nothing,
                # so the switch is synchronous (the JAX package warms the heavy program
                # in a background thread first).  Results stayed exact: escalation costs
                # speed, never correctness.  Nothing is warmed, so a filtered flip
                # files no prep anywhere but the filter's own dict.
                with self._cert_lock:
                    self._cert_mode[(namespace, metric, masked)] = "heavy"
        return dist[:B, :k_eff], idx[:B, :k_eff], ns, state.host_tables

    def _counted_fetch(self, *tensors):
        self.transfer_counts["d2h"] += 1
        return fetch(*tensors)

    # certificate-tier names, indexed by the tier the sweep reports (ops/fused_knn_t)
    _TIER_NAMES = {0: "fast", 1: "widened", 2: "exact_scan", -1: "disengaged"}

    def _record_cert_tier(self, namespace: str, tier: int, light: bool = False) -> None:
        """Count which certificate tier served each batch, per namespace."""
        name = self._TIER_NAMES.get(tier, str(tier))
        if light:
            name = f"light_{name}"
        with self._cert_lock:
            d = self._cert_tiers.setdefault(namespace, {})
            d[name] = d.get(name, 0) + 1

    def cert_tier_counts(self, namespace: str) -> Dict[str, int]:
        with self._cert_lock:
            return dict(self._cert_tiers.get(namespace, {}))

    def _use_light(self, namespace: str, state, metric: str = "l2",
                   masked: bool = False) -> bool:
        """Adaptive certified dispatch (config.adaptive_certify): serve a namespace with
        the light single-pass program until an escalation to the exact scan shows that
        its corpus needs the heavy residual-corrected one.  Only a bf16 mirror with its
        residual codes has both programs: an int8 mirror's band is too wide for the light
        proof by construction, and an f32 mirror has one program (query_processor.py:
        568-588 of the JAX package)."""
        if not (self.config.certify_exact and self.config.adaptive_certify):
            return False
        if (state.sweep_resid is None or state.mirror is None
                or state.mirror.dtype != torch.bfloat16):
            return False
        return self._cert_mode.get((namespace, metric, masked), "light") == "light"

    def _to_user_score(self, dist: np.ndarray, metric: str) -> np.ndarray:
        # reference convention (index.py:121-128): cosine -> 1 - dist; else raw distance
        return 1.0 - dist if HIGHER_IS_BETTER[metric] else dist

    # ------------------------------------------------------------------ public queries

    def find_similar(
        self,
        query: VectorDTO,
        top_k: int = 10,
        namespace: str = "default",
        metric: Optional[str] = None,
        filter: Optional[Dict[str, Any]] = None,
        nprobe: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        return self.find_similar_batch([query], top_k, namespace, metric, filter, nprobe)[0]

    def find_similar_batch(
        self,
        queries: Sequence[VectorDTO],
        top_k: int = 10,
        namespace: str = "default",
        metric: Optional[str] = None,
        filter: Optional[Dict[str, Any]] = None,
        nprobe: Optional[int] = None,
    ) -> List[List[Dict[str, Any]]]:
        """Batched exact kNN — the QPS path; recall is 1.0.  ``filter``: a metadata filter
        spec (filters.py); only matching live rows are ranked, and a query gets fewer
        than ``top_k`` results when fewer rows match."""
        if nprobe is not None:
            raise NotImplementedError("nprobe= is not ported yet (ROADMAP A13: IVF)")
        m = canonical_metric(metric or self.config.default_metric)
        q_np = np.stack([np.asarray(q.values, np.float32).reshape(-1) for q in queries])

        cache_key = self._result_cache_key(q_np, top_k, namespace, m, filter)
        if cache_key is not None:
            with self._result_cache_lock:
                hit = self._result_cache.get(cache_key)
                if hit is not None:
                    self._result_cache.move_to_end(cache_key)  # LRU touch
                    self._result_cache_hits += 1
            if hit is not None:
                # shallow-copy the result dicts so a caller mutating a hit can't
                # poison later cache reads
                return [[dict(r) for r in rs] for rs in hit]

        dist, slots, ns, tables = self._raw_search(q_np, namespace, top_k, m, filter)
        if ns is None:
            results: List[List[Dict[str, Any]]] = [[] for _ in queries]
        else:
            user = self._to_user_score(dist, m)
            with trace_span("hydrate", namespace=namespace, batch=len(queries)):
                results = self._hydrate_batch(user, dist, slots, tables)
        if cache_key is not None:
            # store a private copy: the caller owns the returned dicts
            with self._result_cache_lock:
                while len(self._result_cache) >= self.config.result_cache_size:
                    self._result_cache.popitem(last=False)  # evict least-recently-used
                self._result_cache[cache_key] = [[dict(r) for r in rs] for rs in results]
        return results

    def _hydrate_batch(self, user, dist, slots, tables) -> List[List[Dict[str, Any]]]:
        """Hydrate a whole [B, k] result block of store slots into per-query result lists.

        One vectorized numpy mask prefilters the block, then a single flat pass reads the
        snapshot's slot tables (one atomic capture, so a racing compaction cannot pair
        one generation's ids with another's values).  Metadata dicts are copied; values
        alias the host mirror.  The native extension (native/hydrate.c) builds the same
        lists in one C pass where it loads.
        """
        ids, metas, vals = tables
        n_slots = len(ids)
        native = _hydrate_native()
        if native is not None:
            # ONE C pass: mask, row construction, delete-after-snapshot drops and
            # per-query chunking together
            return native.build_nested(
                ids, vals, metas,
                np.ascontiguousarray(slots).reshape(-1),
                np.ascontiguousarray(user).reshape(-1),
                np.ascontiguousarray(dist).reshape(-1),
                float(MASKED) / 2, user.shape[0], slots.shape[1],
            )
        keep = (dist < float(MASKED) / 2) & (slots >= 0) & (slots < n_slots)
        counts = keep.sum(axis=1).tolist()
        fs = slots[keep].tolist()
        fu = user[keep].tolist()
        rows = [
            {
                "id": ids[slot],
                "values": vals[slot],
                "metadata": dict(m) if (m := metas[slot]) else {},
                "score": sc,
            }
            for slot, sc in zip(fs, fu)
        ]
        # a hit can reference a slot deleted AFTER the snapshot published (the shared
        # host lists are nulled in place): drop those, mirroring the reference's
        # silently-dropping hydration (query_processor.py:38-49)
        dropping = any(r["id"] is None or r["values"] is None for r in rows)
        out, pos = [], 0
        for c in counts:
            chunk = rows[pos : pos + c]
            pos += c
            if dropping:
                chunk = [r for r in chunk if r["id"] is not None and r["values"] is not None]
            out.append(chunk)
        return out

    def range_search(
        self,
        query: VectorDTO,
        radius: float,
        namespace: str = "default",
        metric: Optional[str] = None,
        filter: Optional[Dict[str, Any]] = None,
        limit: int = 1000,
    ) -> List[Dict[str, Any]]:
        """All vectors within ``radius`` of the query (query_processor.py:828-858): one
        k = ``limit`` search, best first, then the radius in user-score units: l2/ip ->
        distance <= radius; cosine -> similarity >= radius."""
        m = canonical_metric(metric or self.config.default_metric)
        q_np = np.asarray(query.values, np.float32).reshape(1, -1)
        dist, slots, ns, tables = self._raw_search(q_np, namespace, limit, m, filter)
        if ns is None:
            return []
        hits = self._hydrate_batch(self._to_user_score(dist, m), dist, slots, tables)[0]
        if HIGHER_IS_BETTER[m]:
            return [h for h in hits if h["score"] >= radius]
        return [h for h in hits if h["score"] <= radius]

    def similarity_search(
        self,
        query: VectorDTO,
        threshold: float,
        namespace: str = "default",
        filter: Optional[Dict[str, Any]] = None,
        limit: int = 1000,
    ) -> List[Dict[str, Any]]:
        """Cosine-similarity threshold search (query_processor.py:860-869)."""
        return self.range_search(query, threshold, namespace, "cosine", filter, limit)

    def query_by_metadata(
        self, filter: Dict[str, Any], namespace: str = "default", limit: int = 1000
    ) -> List[Dict[str, Any]]:
        """Pure metadata query (query_processor.py:871-882): the first ``limit`` matching
        vectors as result dicts with score 0.0."""
        vecs = self.storage.query_by_metadata(filter, namespace)[:limit]
        return [{"id": v.id, "values": v.values, "metadata": v.metadata, "score": 0.0}
                for v in vecs]

    # ------------------------------------------------------------------ helpers
    # (parity with reference query_processor.py:64-82)

    def list_namespaces(self) -> List[str]:
        return self.storage.list_namespaces()

    def get_namespace_vectors(self, namespace: str = "default") -> List[Vector]:
        ns = self.storage.namespace(namespace)
        return ns.all_vectors() if ns else []

    def get_namespace_count(self, namespace: str = "default") -> int:
        ns = self.storage.namespace(namespace)
        return ns.live_count if ns else 0

    def get_storage_info(self) -> Dict[str, Any]:
        return self.storage.get_storage_info()
