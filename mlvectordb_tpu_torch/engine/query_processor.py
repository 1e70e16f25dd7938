"""Query engine: the counterpart of ``mlvectordb_tpu/engine/query_processor.py``.

The ported slice: insert / upsert_many / bulk_load / delete / delete_namespace, exact
batched search with hydration and the result cache, range / similarity search, metadata
filters on every search (hybrid search) and ``query_by_metadata``, on the row-major path
or, with a ``sweep_dtype`` ("bfloat16", "int8" or "float32"), the certified sweep with
its certificate-tier counters and, for a bf16 mirror, the per-namespace light -> heavy
dispatch.  A filter's mask (native columnar evaluator where it builds) is ANDed into the
liveness mask of one snapshot, and its search prep is scoped inside that snapshot's prep
dict.  Hydration runs in the native ``_hydrate`` extension where it builds.

Durability and operations: snapshots in the JAX package's format (``save`` / ``load``,
``engine/persist.py``; the auto-snapshot thread swaps a finished snapshot in atomically),
the write-ahead log (``enable_wal``: every mutation logged before it applies;
``load(..., wal_path=...)`` replays it; ``engine/wal.py``, the JAX package's format),
namespace offload to host memory, warmup, ``explain_query`` and ``get_statistics``.

IVF (``build_ivf`` / ``drop_ivf``, store/ivf.py): a search passing ``nprobe`` probes that
many clusters of the namespace's index; without an index, or with a filter, it serves the
exact path, as in the JAX package.  The index follows every write and delete, is saved in
snapshots and rebuilt by WAL replay from its logged parameters.

A distributed namespace (parallel/store.py, from ``parallel.make_distributed_processor``)
is searched through its ``sharded_search``: every shard's search, the merge of their
top-k lists, and one copy back of the merged result with every shard's proof.

Reference behaviors kept:
  * k clamped to the live count (index.py:103-107)
  * search of a missing namespace returns [] (index.py:98-99)
  * result dicts {id, values, metadata, score}, silently dropping hits that vanished from
    storage between select and hydrate (query_processor.py:38-49)
  * score convention: l2/ip -> raw distance (lower better), cosine -> similarity = 1 - dist
    (index.py:121-128)
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import threading
import time
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
from ..ops.fused_knn_t import SWEEP_TILE, SweepResult, fetch
from ..store.storage import StorageEngine
from ..store.vector import Vector
from ..utils.tracing import trace_span
from .filters import FilterMaskCache

logger = logging.getLogger(__name__)

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


def _same_device(a: torch.device, b: torch.device) -> bool:
    """One device: the same type, and the same index where both name one."""
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


class QueryStats:
    """Query-type counters and latency accumulators (what ``get_statistics`` reports)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {}
        self.total_ms: Dict[str, float] = {}
        self._stage_counts: Dict[str, int] = {}
        self._stage_ms: Dict[str, float] = {}

    def record(self, kind: str, elapsed_ms: float) -> None:
        with self._lock:
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.total_ms[kind] = self.total_ms.get(kind, 0.0) + elapsed_ms

    def record_stage(self, stage: str, elapsed_ms: float) -> None:
        """Per-stage latency (device dispatch, hydration), not counted as queries."""
        with self._lock:
            self._stage_counts[stage] = self._stage_counts.get(stage, 0) + 1
            self._stage_ms[stage] = self._stage_ms.get(stage, 0.0) + elapsed_ms

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "total_queries": sum(self.counts.values()),
                "queries_by_type": dict(self.counts),
                "avg_latency_ms_by_type": {
                    k: (self.total_ms[k] / c if c else 0.0) for k, c in self.counts.items()
                },
                "stage_budget_ms": {
                    k: round(self._stage_ms[k] / c, 4)
                    for k, c in self._stage_counts.items() if c
                },
            }


class QueryProcessor:
    """Composes the device store with the fused search kernels.

    ``storage``: serve an existing engine (e.g. one ``load_storage`` restored); the
    processor then runs on that engine's device, which must be ``device``."""

    def __init__(
        self,
        config: EngineConfig = DEFAULT_CONFIG,
        *,
        device="cuda",
        storage: Optional[StorageEngine] = None,
    ):
        self.config = config
        self.device = torch.device(device)
        if storage is None:
            storage = StorageEngine(config, device=self.device)
        elif not _same_device(storage.device, self.device):
            raise ValueError(f"storage lives on {storage.device}, the processor on {self.device}")
        else:
            self.device = storage.device
        self.storage = storage
        self._filter_masks = FilterMaskCache()
        self.stats = QueryStats()
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
        # optional write-ahead log (enable_wal): mutations are logged, then applied
        self._wal = None
        self._wal_checkpoint_bytes: Optional[int] = None
        self._wal_replaying = False
        self._snap_thread: Optional[threading.Thread] = None

    def _result_cache_key(self, q_np, top_k, namespace, metric, filter=None, nprobe=None):
        ns = self.storage.namespace(namespace)
        if ns is None or self.config.result_cache_size <= 0:
            return None
        h = hashlib.blake2b(q_np.tobytes(), digest_size=16).hexdigest()
        fk = filter_cache_key(filter) if filter else ""
        # ns.incarnation: version counters restart at 0 when a namespace is GC'd and
        # recreated, so (name, version) alone can resurrect a dead incarnation's results
        return (namespace, ns.incarnation, ns.version, h, top_k, metric, fk, nprobe)

    # ------------------------------------------------------------------ durability

    def enable_wal(
        self, path: str, fsync: bool = False, checkpoint_bytes: Optional[int] = None
    ) -> None:
        """Log every mutation to ``path`` BEFORE applying it (crash durability between
        snapshots).  Recover with ``QueryProcessor.load(snap, wal_path=...)``; ``save()``
        rotates and prunes the covered segments.

        ``checkpoint_bytes``: for WAL-only deployments (no snapshot schedule prunes the
        log): when the segments exceed it, the engine writes a snapshot to
        ``<path>/checkpoint`` (atomic swap) and prunes the covered segments inline on the
        mutating call; ``load(wal_path=...)`` finds the checkpoint."""
        from .wal import WriteAheadLog

        if self._wal is not None:
            raise RuntimeError("WAL already enabled for this processor")
        self._wal = WriteAheadLog(path, fsync=fsync)
        self._wal_checkpoint_bytes = checkpoint_bytes

    def _maybe_checkpoint_wal(self) -> None:
        """WAL-only growth bound: snapshot into <wal>/checkpoint and prune once the log
        exceeds checkpoint_bytes (under the write lock: mutations pause for the copy)."""
        w, limit = self._wal, self._wal_checkpoint_bytes
        if w is None or self._wal_replaying or not limit or w.total_bytes() < limit:
            return
        ckpt = os.path.join(w.path, "checkpoint")
        tmp, old = ckpt + ".tmp", ckpt + ".old"
        with self._write_lock:
            shutil.rmtree(tmp, ignore_errors=True)
            sealed = self._save_snapshot(tmp)
            shutil.rmtree(old, ignore_errors=True)
            if os.path.isdir(ckpt):
                os.rename(ckpt, old)
            os.rename(tmp, ckpt)
            shutil.rmtree(old, ignore_errors=True)
            w.prune(sealed)
        self.stats.record("wal_checkpoint", 0.0)

    def _wal_upsert(self, vs: Sequence[Vector], namespace: str) -> None:
        """Log an upsert batch once the store has checked that it applies: a write the
        store refuses (a dimension mismatch, max_capacity) is never logged, so a replay
        never meets it."""
        if self._wal is None or self._wal_replaying or not vs:
            return
        self.storage.check_write([v.dim for v in vs], [v.id for v in vs], namespace)
        self._wal.append("upsert", namespace, ids=[v.id for v in vs],
                         values=np.stack([v.values for v in vs]),
                         metadatas=[v.metadata for v in vs])
        self._maybe_checkpoint_wal()

    # ------------------------------------------------------------------ writes

    def insert(self, vector: VectorDTO, namespace: str = "default") -> Vector:
        with self._write_lock:
            v = Vector(vector.values, vector.metadata, id=vector.id)
            self._wal_upsert([v], namespace)
            self.storage.write(v, namespace)
            self._sync_ivf_add(namespace, [v])
            return v

    def upsert_many(
        self, vectors: Sequence[VectorDTO], namespace: str = "default"
    ) -> List[Vector]:
        """True upsert: DTOs carrying an id overwrite in place; id-less DTOs mint uuid4."""
        with self._write_lock, trace_span("upsert", namespace=namespace, count=len(vectors)):
            vs = [Vector(d.values, d.metadata, id=d.id) for d in vectors]
            self._wal_upsert(vs, namespace)
            self.storage.write_vectors(vs, namespace)
            self._sync_ivf_add(namespace, vs)
            return vs

    def delete(
        self, vector_ids: Iterable[uuid_mod.UUID], namespace: str = "default"
    ) -> List[uuid_mod.UUID]:
        with self._write_lock, trace_span("delete", namespace=namespace):
            ids = list(vector_ids)
            if self._wal is not None and not self._wal_replaying and ids:
                self._wal.append("delete", namespace, ids=ids)
                self._maybe_checkpoint_wal()
            removed = self.storage.delete_vectors(ids, namespace)
            ivf = self._ivf(namespace)
            if ivf is not None and removed:
                ivf.delete(removed)
            return removed

    def delete_namespace(self, namespace: str) -> bool:
        with self._write_lock:
            if self._wal is not None and not self._wal_replaying:
                self._wal.append("delete_namespace", namespace)
            return self.storage.delete_namespace(namespace)

    # ------------------------------------------------------------------ offload

    def offload_namespace(self, namespace: str) -> bool:
        """Move a cold namespace's device arrays to host memory, freeing the device for
        hot ones.  Host-table reads keep working; the first search or write pages it back
        in."""
        ns = self.storage.namespace(namespace)
        if ns is None:
            return False
        with self._write_lock:
            return ns.offload()

    def restore_namespace(self, namespace: str) -> bool:
        ns = self.storage.namespace(namespace)
        return ns.ensure_resident() if ns is not None else False

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
        device scatter; each batch is logged (with the WAL on) once its ids are known.  An
        attached IVF index is kept in step from the contiguous array.
        """
        values = np.ascontiguousarray(values, np.float32)
        n = values.shape[0]
        out = []
        with self._write_lock, trace_span("bulk_load", namespace=namespace, count=n):
            ns = self.storage.namespace(namespace, create=True)
            for lo in range(0, n, batch_rows):
                hi = min(lo + batch_rows, n)
                got = ns.bulk_upsert(
                    values[lo:hi],
                    ids[lo:hi] if ids is not None else None,
                    metadatas[lo:hi] if metadatas is not None else None,
                )
                if self._wal is not None and not self._wal_replaying:
                    self._wal.append(
                        "upsert", namespace, ids=got, values=values[lo:hi],
                        metadatas=list(metadatas[lo:hi]) if metadatas is not None else None,
                    )
                    self._maybe_checkpoint_wal()
                out.extend(got)
            if ns.ivf is not None:
                ns.ivf.add_bulk(values, out)
        return out

    # ------------------------------------------------------------------ IVF

    def _ivf(self, namespace: str):
        """The namespace's IVF index, or None."""
        ns = self.storage.namespace(namespace)
        return None if ns is None else ns.ivf

    def _sync_ivf_add(self, namespace: str, vectors: Sequence[Vector]) -> None:
        ivf = self._ivf(namespace)
        if ivf is not None and vectors:
            ivf.add(vectors)

    def build_ivf(
        self,
        namespace: str = "default",
        n_clusters: Optional[int] = None,
        cluster_capacity: Optional[int] = None,
        n_iters: int = 10,
        seed: int = 0,
        spill: int = 1,
    ) -> Dict[str, Any]:
        """Train and attach an IVF approximate index to a namespace (store/ivf.py); later
        searches passing ``nprobe`` use it, exact search stays the default.  ``spill`` > 1
        places each vector in its ``spill`` nearest clusters.  Logged (with the WAL on)
        before it applies; k-means is seeded, so a replay rebuilds the same index from the
        same rows."""
        from ..store.ivf import IVFIndex

        with self._write_lock, trace_span("ivf_build", namespace=namespace):
            ns = self.storage.namespace(namespace)
            if ns is None:
                raise ValueError(f"namespace {namespace!r} does not exist")
            if self._wal is not None and not self._wal_replaying:
                self._wal.append("build_ivf", namespace, params={
                    "n_clusters": n_clusters, "cluster_capacity": cluster_capacity,
                    "n_iters": n_iters, "seed": seed, "spill": spill})
            with ns._lock:
                ns.ivf = IVFIndex(ns, n_clusters, cluster_capacity, n_iters, seed, spill)
                # a (re)built index changes what nprobe searches return: the version bump
                # keeps the result cache from serving the old index's answers
                ns.version += 1
            return ns.ivf.stats()

    def drop_ivf(self, namespace: str = "default") -> bool:
        ns = self.storage.namespace(namespace)
        if ns is None or ns.ivf is None:
            return False
        if self._wal is not None and not self._wal_replaying:
            self._wal.append("drop_ivf", namespace)
        with ns._lock:
            ns.ivf = None
            ns.version += 1  # nprobe searches now serve the exact path: invalidate
        return True

    def _ivf_search(self, q_np: np.ndarray, ns, ivf, namespace: str, k: int, metric: str,
                    nprobe: int):
        """The approximate path: (dist [B, k'] np, ivf slots [B, k'] np, resolver) with
        k' = min(k * spill, C * L), over-fetched so that k unique ids survive the
        deduplication of spill copies in hydration.  Only the live queries are computed
        (nothing on this path reads padded rows); one copy each way."""
        k_fetch = min(min(k, ns.live_count) * ivf.spill, ivf.C * ivf.L)
        q = np.zeros((q_np.shape[0], ns.dpad), np.float32)
        q[:, : ns.dim] = q_np
        with trace_span("knn_ivf", namespace=namespace, k=k_fetch, nprobe=nprobe):
            self.transfer_counts["h2d"] += 1
            # the resolver is bound to the generation that produced the slots
            dist, idx, resolve = ivf.search_resolved(
                torch.from_numpy(q).to(self.device), k_fetch, metric, nprobe)
            self.transfer_counts["d2h"] += 1
            dist, idx = fetch(dist, idx)
        return dist, idx, resolve

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
        # a distributed namespace (parallel/store.py): per-shard states, merged top-k
        sharded = hasattr(ns, "sharded_search")
        valid, prep_cache = (None, None) if sharded else (state.valid, state.prep_cache)
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
            if mask.shape[0] != state.capacity:  # capacity changed mid-snapshot
                raise RuntimeError("snapshot deleted (capacity changed)")
            if ns.version != v0:
                # a write published between the version read and the mask build: the
                # mask (live tables, keyed by the live version) may not match the
                # snapshot's arrays, so re-snapshot
                raise RuntimeError("snapshot deleted (version moved during mask build)")
            if sharded:
                # each shard's liveness and prep are scoped in its own prep dict
                c = state.capacity // ns.n_shards
                scopes = [[self._filter_scope(st, mask[s * c:(s + 1) * c], filter)
                           for s, st in enumerate(row)] for row in state.shards]
                valid = [[v for v, _ in row] for row in scopes]
                prep_cache = [[p for _, p in row] for row in scopes]
            else:
                valid, prep_cache = self._filter_scope(state, mask, filter)
        # counters come from the SNAPSHOT, never the live store attributes: a concurrent
        # upsert bumps host tables before publishing the scattered arrays, and pairing
        # old data with the new high-water would admit never-written all-zero rows
        k_eff = min(k, state.live_count)
        B = q_np.shape[0]
        if k_eff <= 0:
            empty = np.zeros((B, 0))
            return empty, empty.astype(np.int32), ns, state.host_tables
        kb = min(self.config.bucket_k(k_eff), state.capacity)
        Bb = self.config.bucket_batch(B)
        q_pad = np.zeros((Bb, ns.dpad), np.float32)
        q_pad[:B, : ns.dim] = q_np

        self.transfer_counts["h2d"] += 1
        q_dev = torch.from_numpy(q_pad).to(self.device)
        if sharded:
            return self._search_sharded(q_dev, ns, state, namespace, B, Bb, kb, k_eff,
                                        metric, valid if filter else None,
                                        prep_cache if filter else None)
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

    def _search_sharded(self, q_dev, ns, state, namespace, B, Bb, kb, k_eff, metric,
                        valid, prep):
        """The sharded branch (query_processor.py:481-487 of the JAX package): every shard
        searched with the sweep's proof left on the device, the shards' tier-1 lists
        merged on the device, and the merged (dist, idx) fetched with every shard's proof
        in ONE copy; a failed proof escalates that shard alone (counted copies) and
        merges again.  No certificate tier is recorded, as in the JAX package."""
        with trace_span("knn_sharded", namespace=namespace, k=kb, batch=Bb):
            out = ns.sharded_search(q_dev, kb, metric, valid_override=valid, state=state,
                                    prep=prep, n_live=B, defer=True)
            parts = (out.dist, out.idx) + (() if out.okq is None else (out.okq,))
            self.transfer_counts["d2h"] += 1
            host = fetch(*parts)
        dist, idx = host[0], host[1]
        if out.okq is not None and not host[2].all():
            dist, idx, _tier = out.escalate(host[2], self._counted_fetch)
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
        if not self._has_light(state.mirror, state.sweep_resid):
            return False
        return self._cert_mode.get((namespace, metric, masked), "light") == "light"

    def _has_light(self, mirror, resid) -> bool:
        """Whether a namespace with this sweep mirror and these residual codes is served
        by the adaptive light/heavy switch: both certified programs exist only for a bf16
        mirror with its residual codes."""
        return (self.config.certify_exact and self.config.adaptive_certify
                and resid is not None and mirror is not None
                and mirror.dtype == torch.bfloat16)

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
        than ``top_k`` results when fewer rows match.  ``nprobe``: serve from the
        namespace's IVF index (build_ivf first), probing that many clusters; without an
        index, or with a filter, the exact path serves."""
        t0 = time.perf_counter()
        m = canonical_metric(metric or self.config.default_metric)
        q_np = np.stack([np.asarray(q.values, np.float32).reshape(-1) for q in queries])

        cache_key = self._result_cache_key(q_np, top_k, namespace, m, filter, nprobe)
        if cache_key is not None:
            with self._result_cache_lock:
                hit = self._result_cache.get(cache_key)
                if hit is not None:
                    self._result_cache.move_to_end(cache_key)  # LRU touch
                    self._result_cache_hits += 1
            if hit is not None:
                self.stats.record("cache_hit", (time.perf_counter() - t0) * 1e3)
                # shallow-copy the result dicts so a caller mutating a hit can't
                # poison later cache reads
                return [[dict(r) for r in rs] for rs in hit]

        t_dev = time.perf_counter()
        ns = self.storage.namespace(namespace)
        ivf = None if nprobe is None or filter is not None or ns is None else ns.ivf
        if ivf is not None and ns.live_count > 0 and top_k > 0:
            if q_np.shape[1] != ns.dim:
                raise ValueError(
                    f"query dim {q_np.shape[1]} != namespace {namespace!r} dim {ns.dim}")
            dist, slots, resolve = self._ivf_search(q_np, ns, ivf, namespace, top_k, m, nprobe)
        else:
            resolve = None
            dist, slots, ns, tables = self._raw_search(q_np, namespace, top_k, m, filter)
        self.stats.record_stage("device", (time.perf_counter() - t_dev) * 1e3)
        if ns is None:
            results: List[List[Dict[str, Any]]] = [[] for _ in queries]
        else:
            user = self._to_user_score(dist, m)
            t_hyd = time.perf_counter()
            with trace_span("hydrate", namespace=namespace, batch=len(queries)):
                if resolve is None:
                    results = self._hydrate_batch(user, dist, slots, tables)
                else:
                    results = [self._hydrate_scored(user[i], dist[i], slots[i], ns, resolve,
                                                    limit=top_k)
                               for i in range(len(queries))]
            self.stats.record_stage("hydrate", (time.perf_counter() - t_hyd) * 1e3)
        kind = "hybrid" if filter else ("ivf" if nprobe is not None else "knn")
        self.stats.record(kind, (time.perf_counter() - t0) * 1e3)
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

    @staticmethod
    def _hydrate_scored(user_row, dist_row, slot_row, ns, resolver,
                        limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """One query's IVF hits as result dicts: ``resolver`` maps index slots to ids,
        masked slots and vanished ids are dropped, and a spilled index's duplicate copies
        of one id keep the first (best-ranked) one (query_processor.py:803-826 of the JAX
        package)."""
        half_masked = float(MASKED) / 2
        out, seen = [], set()
        for u, d, slot in zip(user_row.tolist(), dist_row.tolist(), slot_row.tolist()):
            if d >= half_masked:
                continue
            vid = resolver(int(slot))
            if vid is None or vid in seen:
                continue
            vec = ns.get(vid)
            if vec is None:
                continue
            seen.add(vid)
            out.append({"id": vid, "values": vec.values, "metadata": vec.metadata,
                        "score": float(u)})
            if limit is not None and len(out) >= limit:
                break
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
        t0 = time.perf_counter()
        m = canonical_metric(metric or self.config.default_metric)
        q_np = np.asarray(query.values, np.float32).reshape(1, -1)
        dist, slots, ns, tables = self._raw_search(q_np, namespace, limit, m, filter)
        hits = [] if ns is None else self._hydrate_batch(
            self._to_user_score(dist, m), dist, slots, tables)[0]
        if HIGHER_IS_BETTER[m]:
            hits = [h for h in hits if h["score"] >= radius]
        else:
            hits = [h for h in hits if h["score"] <= radius]
        self.stats.record("range", (time.perf_counter() - t0) * 1e3)
        return hits

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
        t0 = time.perf_counter()
        vecs = self.storage.query_by_metadata(filter, namespace)[:limit]
        out = [{"id": v.id, "values": v.values, "metadata": v.metadata, "score": 0.0}
               for v in vecs]
        self.stats.record("metadata", (time.perf_counter() - t0) * 1e3)
        return out

    # ------------------------------------------------------------------ operations

    def _explain_dispatch(self, ns, namespace, metric, *, masked, fused_active):
        """The dispatch label for explain_query, read from the store's attributes (an
        empty or offloaded namespace neither raises nor pages in)."""
        if ns is not None and self._has_light(ns._mirror, ns._sweep_resid):
            return self._cert_mode.get((namespace, metric, masked), "light")
        return "heavy" if fused_active else "exact-scan"

    def explain_query(
        self,
        query: VectorDTO,
        top_k: int = 10,
        namespace: str = "default",
        metric: Optional[str] = None,
        filter: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Describe the execution plan without running it.  The fused sweep engages on
        any device here (the kernels' plain versions serve CPU tensors), so its
        ``fused_active`` reads the config and the capacity alone (ROADMAP §C)."""
        m = canonical_metric(metric or self.config.default_metric)
        ns = self.storage.namespace(namespace)
        live = ns.live_count if ns else 0
        cap = ns.capacity if ns else 0
        kb = min(self.config.bucket_k(min(top_k, max(live, 1))), max(cap, 1))
        fused_active = (self.config.use_pallas and self.config.sweep_dtype is not None
                        and cap >= 2 * SWEEP_TILE)
        margin_mode = fused_active and not self.config.certify_exact
        if self.config.certify_exact:
            contract = (
                "certified: per-query on-device proof that no pruned window can "
                "hold a true neighbour; escalates to wider selection / exact scan"
            )
        elif margin_mode:
            contract = (
                "margin: fast selection tier returned unconditionally; exactness "
                "rests on the empirical selection margin + benchmark recall gates "
                "(certify_exact=False)"
            )
        else:
            contract = "exact by construction (full scan / fused kernel disengaged)"
        return {
            "query_type": "hybrid" if filter else "knn",
            "namespace": namespace,
            "metric": m,
            "higher_is_better": HIGHER_IS_BETTER[m],
            "exact": not margin_mode,
            "certified": bool(self.config.certify_exact),
            "exactness_contract": contract,
            "certificate_tiers": self.cert_tier_counts(namespace),
            "certificate_dispatch": self._explain_dispatch(
                ns, namespace, m, masked=bool(filter), fused_active=fused_active)
            if self.config.certify_exact
            else "margin" if margin_mode else "exact-scan",
            "expected_recall": None if margin_mode else 1.0,
            "live_vectors": live,
            "scanned_slots": cap,
            "k_requested": top_k,
            "k_effective": min(top_k, live),
            "k_kernel_bucket": kb,
            "db_tile": min(self.config.db_tile, cap) if cap else 0,
            "backend": getattr(knn_backend(self.config), "__name__", "exact_knn"),
            "filter": filter,
        }

    def get_statistics(self) -> Dict[str, Any]:
        out = self.stats.as_dict()
        out["exactness"] = {
            "certify_exact": bool(self.config.certify_exact),
            "contract": "certified" if self.config.certify_exact else "margin",
        }
        with self._cert_lock:
            if self._cert_tiers:
                # which certificate tier served each batch, per namespace
                out["exactness"]["tiers_by_namespace"] = {
                    ns: dict(d) for ns, d in self._cert_tiers.items()
                }
        return out

    def warmup(
        self,
        namespace: str = "default",
        ks: Sequence[int] = (10, 100),
        batches: Optional[Sequence[int]] = None,
        metrics: Sequence[str] = ("l2", "cosine"),
        detail: bool = False,
        include_masked: Optional[bool] = None,
    ):
        """Run each search program a serving deployment will hit once before traffic.

        Eager torch compiles nothing per shape, so what warmup takes off the first
        queries is the build and load of the kernel library (on a CUDA device) and of the
        native host runtime, the device's first launches, and each program's
        query-independent prep, filed in the snapshot's prep dict as a search files it.
        Each (batch bucket, k bucket, metric, variant) program is launched once, serially,
        through the backend call the search makes, with one zero query in the bucket; no
        data, version or capacity changes.  Returns the programs run, with ``detail=True``
        a ``(count, {"b{B}_k{kb}_{metric}_{fast|masked}": seconds})`` pair.  A sharded
        namespace runs one ``..._sharded`` program per (bucket, k bucket, metric): its
        whole zero batch through ``sharded_search``, every shard of every replica.

        ``batches`` defaults to every config batch bucket up to 512.  ``include_masked``:
        also run the masked variant (tombstones or filters present); None = only when the
        namespace carries tombstones."""
        ns = self.storage.namespace(namespace)
        if ns is None or ns.live_count == 0:
            return (0, {}) if detail else 0
        if self.device.type == "cuda":
            from ..ops import _kernels

            _kernels.library()
        from ..native import available as native_available

        native_available()
        _hydrate_native()
        if batches is None:
            batches = [b for b in self.config.query_buckets if b <= 512] or [8]
        state = ns.device_state()
        if include_masked is None:
            include_masked = state.live_count != state.high_water
        variants = (None, state.high_water) if include_masked else (state.high_water,)
        sharded = hasattr(ns, "sharded_search")
        backend = knn_backend(self.config)
        want_tier = (bool(self.config.certify_exact) and not sharded
                     and state.mirror is not None)
        report: Dict[str, float] = {}
        for m in metrics:
            mc = canonical_metric(m)
            for b in batches:
                Bb = self.config.bucket_batch(b)
                for k in ks:
                    kb = min(self.config.bucket_k(min(k, state.live_count)), state.capacity)
                    if sharded:
                        key = f"b{Bb}_k{kb}_{mc}_sharded"
                        if key not in report:
                            t0 = time.perf_counter()
                            d, _ = ns.sharded_search(
                                torch.zeros((Bb, ns.dpad), dtype=torch.float32,
                                            device=self.device), kb, mc, state=state)
                            fetch(d[:1, :1])   # a readback: every shard ran to its end
                            report[key] = round(time.perf_counter() - t0, 3)
                        continue
                    for live_prefix in variants:
                        key = f"b{Bb}_k{kb}_{mc}_{'masked' if live_prefix is None else 'fast'}"
                        if key in report:
                            continue
                        t0 = time.perf_counter()
                        out = backend(
                            torch.zeros((Bb, ns.dpad), dtype=torch.float32, device=self.device),
                            state.data, state.valid, state.sq_norms,
                            k=kb, metric=mc, db_tile=self.config.db_tile,
                            live_prefix=live_prefix, report_tier=want_tier,
                            mirror=state.mirror, sweep_err=state.sweep_err,
                            sweep_resid=state.sweep_resid, sweep_rscale=state.sweep_rscale,
                            sweep_err1=state.sweep_err1, sweep_rscale2=state.sweep_rscale2,
                            sweep_light=self._use_light(namespace, state, mc,
                                                        masked=live_prefix is None),
                            sweep_prep=state.prep_cache, n_live=1,
                        )
                        fetch(out[0][:1, :1])   # a readback: the program ran to its end
                        report[key] = round(time.perf_counter() - t0, 3)
        return (len(report), report) if detail else len(report)

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

    # ------------------------------------------------------------------ persistence

    def _save_snapshot(self, path: str) -> List[str]:
        """Rotate the WAL (if enabled) under the write lock, so every record the snapshot
        covers is in a sealed segment, then write the snapshot.  Returns the sealed
        segments: the CALLER prunes them once the snapshot is in its final,
        recovery-visible place.  Writes landing in the fresh segment during the snapshot
        replay idempotently."""
        from .persist import save_storage

        sealed: List[str] = []
        if self._wal is not None:
            with self._write_lock:
                sealed = self._wal.rotate()
        save_storage(self.storage, path)
        return sealed

    def save(self, path: str) -> None:
        sealed = self._save_snapshot(path)
        if self._wal is not None:
            self._wal.prune(sealed)

    @classmethod
    def load(
        cls,
        path: str,
        config: EngineConfig = DEFAULT_CONFIG,
        wal_path: Optional[str] = None,
        wal_fsync: bool = False,
        wal_checkpoint_bytes: Optional[int] = None,
        *,
        device="cuda",
    ) -> "QueryProcessor":
        """Restore from a snapshot directory onto ``device``; with ``wal_path``, replay
        the write-ahead log on top (everything after the snapshot) and keep logging to
        it.  With no snapshot at ``path``, a ``<wal_path>/checkpoint`` written by WAL-only
        checkpointing is loaded before the remaining segments replay."""
        from .persist import load_storage, resolve_snapshot_dir

        snap = resolve_snapshot_dir(path) or (path if os.path.isdir(path) else None)
        if snap is None and wal_path:   # WAL-only recovery
            snap = resolve_snapshot_dir(os.path.join(wal_path, "checkpoint"))
        storage = None if snap is None else load_storage(snap, config, device=device)
        qp = cls(config=config, device=device, storage=storage)
        if wal_path is not None:
            qp.replay_wal(wal_path)
            qp.enable_wal(wal_path, fsync=wal_fsync, checkpoint_bytes=wal_checkpoint_bytes)
        return qp

    def replay_wal(self, wal_path: str) -> int:
        """Re-apply logged mutations (idempotent); returns the records applied.  A
        ``build_ivf`` that no longer applies (its rows were deleted later in the log) is
        skipped with a warning, and so is a record whose op this package does not know
        (a newer writer's): both count as applied, as in the JAX package."""
        from .wal import WriteAheadLog

        applied = 0
        self._wal_replaying = True
        try:
            for rec in WriteAheadLog.replay(wal_path):
                op, ns = rec["op"], rec["ns"]
                if op == "upsert":
                    self.bulk_load(rec["values"], ns,
                                   ids=[uuid_mod.UUID(x) for x in rec["ids"]],
                                   metadatas=rec.get("meta"))
                elif op == "delete":
                    self.delete([uuid_mod.UUID(x) for x in rec["ids"]], ns)
                elif op == "delete_namespace":
                    self.storage.delete_namespace(ns)
                elif op == "build_ivf":
                    try:
                        self.build_ivf(ns, **(rec.get("params") or {}))
                    except (ValueError, RuntimeError):
                        logger.warning("WAL replay: build_ivf(%s) not applicable, skipped", ns)
                elif op == "drop_ivf":
                    self.drop_ivf(ns)
                else:
                    logger.warning("WAL replay: unknown record op %r for namespace %r skipped",
                                   op, ns)
                applied += 1
        finally:
            self._wal_replaying = False
        return applied

    # the reference README's persistence surface, mapped onto snapshots

    def save_index(self, path: str) -> None:
        self.save(path)

    def load_index(self, path: str) -> None:
        from .persist import load_storage

        self.storage = load_storage(path, self.config, device=self.device)

    def create_backup(self, path: str) -> None:
        self.save(path)

    def restore_from_backup(self, path: str) -> None:
        self.load_index(path)

    def start_auto_snapshot(self, path: str, interval_s: float = 300.0) -> None:
        """Periodic background checkpointing (recover with ``QueryProcessor.load(path)``).
        Each snapshot is written to ``path + ".tmp"`` and swapped in by renames, so
        ``path`` (or ``path + ".old"`` between the two renames) always holds a complete
        one; skipped when no namespace changed."""
        if self._snap_thread is not None:
            raise RuntimeError("auto-snapshot already running")
        self._snap_stop = threading.Event()

        def versions() -> tuple:
            return tuple(sorted((name, ns.version) for name in self.storage.list_namespaces()
                                if (ns := self.storage.namespace(name)) is not None))

        def loop():
            last = None
            while not self._snap_stop.wait(interval_s):
                try:
                    cur = versions()
                    if cur == last:
                        continue
                    tmp, old = path + ".tmp", path + ".old"
                    shutil.rmtree(tmp, ignore_errors=True)
                    sealed = self._save_snapshot(tmp)
                    shutil.rmtree(old, ignore_errors=True)
                    if os.path.isdir(path):
                        os.rename(path, old)
                    os.rename(tmp, path)
                    shutil.rmtree(old, ignore_errors=True)
                    # only now is the snapshot recovery-visible: drop the segments it covers
                    if self._wal is not None:
                        self._wal.prune(sealed)
                    last = cur
                    self.stats.record("auto_snapshot", 0.0)
                except Exception:  # keep checkpointing alive
                    logger.exception("auto-snapshot failed")

        self._snap_thread = threading.Thread(target=loop, daemon=True, name="auto-snapshot")
        self._snap_thread.start()

    def stop_auto_snapshot(self) -> None:
        t = self._snap_thread
        if t is not None:
            self._snap_stop.set()
            t.join(timeout=10)
            self._snap_thread = None
