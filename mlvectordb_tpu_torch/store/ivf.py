"""IVF index: the counterpart of ``mlvectordb_tpu/store/ivf.py``, the opt-in approximate
inverted-file search.

A k-means coarse quantizer (ops/kmeans.py) partitions the namespace into cluster-major
device storage ``[C, L, Dp]`` (every cluster owns a fixed L-row region), and a query scans
only its ``nprobe`` nearest clusters.  Probing all C clusters degenerates to exact search,
which the tests use as an oracle.  The index holds its own copy of the vectors, in the
store's dtype (a bf16 store's copy stays bf16; the search upcasts the rows to f32), and
recall is below 1.0 at small nprobe; the engine uses it only when the caller passes
``nprobe``.  Rows overflowing a full cluster go to the nearest cluster with free space
(greedy, on the host), so full-probe search stays exact.  With ``spill`` > 1 each vector
also sits in its next nearest clusters (best effort), and the engine drops the duplicate
ids in hydration.

The JAX package computes all of this with XLA ops (no Pallas kernel), so the port is torch
ops: the probe scan is a Python loop over probe steps, each a block gather, a batched
product and a fold into the carried top-k (ops/topk._fold_tile).  A build places the ids
as the JAX package's host loop does (id by id in the store's order, then the overflow),
so an index built from the same centroids holds every id in the same slot; the in-order
part is one stable sort per cluster rather than a Python step per id, and the rows and
norms move into the cluster arrays in one device scatter.

Over a sharded store (parallel/store.py) the index is cluster-sharded, as the JAX
package's is: C rounds up to a multiple of the shard count, the cluster arrays are
``[R][S]`` grids of ``[C/S, L, ...]`` blocks on the mesh's cells (the centroids stay on
the home device, replicated), and a probe runs ``ShardingManager.sharded_ivf_probe``:
each shard scans the probed clusters it owns and the shards' lists merge.  The build
itself (k-means, assignment, layout) runs on the home device over the store's gathered
rows.  A snapshot whose C does not split over this mesh's shards loads unsharded.
"""

from __future__ import annotations

import uuid as uuid_mod
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops.distances import MASKED, pairwise_distances, require_f32_matmul
from ..ops.kmeans import assign_topm, train_kmeans
from ..ops.topk import _fold_tile
from ..utils.tracing import trace_span

# overflowed rows whose float64 distances to every centroid are computed at once
_OVERFLOW_BLOCK = 64


class _IVFGen(NamedTuple):
    """One generation of the index, published atomically.

    Searches read ``IVFIndex._gen`` once and derive everything (probe geometry, cluster
    arrays, slot -> id resolution) from that read, so a concurrent retrain, which replaces
    the whole tuple, never hands a reader new centroids with old cluster arrays.
    ``slot_ids`` is the live list shared with incremental add/delete: a slot a writer
    newly fills is invalid in an older reader's ``valid3``, so it never surfaces, and a
    deleted slot resolves to None and is dropped."""

    centroids: torch.Tensor
    cnorms: torch.Tensor
    data3: torch.Tensor
    valid3: torch.Tensor
    sqn3: torch.Tensor
    slot_ids: List[Optional[uuid_mod.UUID]]
    C: int
    L: int

    def resolver(self) -> Callable[[int], Optional[uuid_mod.UUID]]:
        ids, n = self.slot_ids, self.C * self.L
        return lambda slot: ids[slot] if 0 <= slot < n else None


def _ivf_search(q, centroids, cnorms, data3, valid3, sqn3, *, k, metric, nprobe, c_off=0):
    """q [B, Dp] -> (dist [B, k], ivf_slot [B, k] int32); ivf_slot = cluster * L + local.

    The probed clusters are the nprobe nearest centroids, nearest first and the lower id
    first among equal distances (``lax.top_k``'s order).  ``data3`` / ``valid3`` /
    ``sqn3`` may be one shard's block of clusters ``[c_off, c_off + C_loc)``: a probed
    cluster outside it is masked (sharding.py:187-197 of the JAX package)."""
    require_f32_matmul()
    B = q.shape[0]
    C, L, _ = data3.shape
    q32 = q.float()
    qn = (q32 * q32).sum(-1)
    probe_d = pairwise_distances(q32, centroids, cnorms, qn, metric)          # [B, C]
    probed = torch.sort(probe_d, dim=1, stable=True).indices[:, :nprobe]      # [B, nprobe]
    best_d = torch.full((B, k), float(MASKED), dtype=torch.float32, device=q.device)
    best_i = torch.zeros((B, k), dtype=torch.int32, device=q.device)
    local = torch.arange(L, dtype=torch.int32, device=q.device)
    for j in range(nprobe):
        cids = probed[:, j]
        loc = cids - c_off
        owned = (loc >= 0) & (loc < C)
        locc = loc.clamp(0, C - 1)
        rows = data3[locc].float()                                # [B, L, Dp] block gather
        dots = torch.bmm(rows, q32[:, :, None])[:, :, 0]          # [B, L]
        sq = sqn3[locc]
        if metric == "l2":
            d = torch.clamp_min(qn[:, None] + sq - 2.0 * dots, 0.0)
        elif metric == "ip":
            d = 1.0 - dots
        else:
            d = 1.0 - dots * torch.rsqrt(torch.clamp_min(qn[:, None] * sq, 1e-30))
        d = torch.where(valid3[locc] & owned[:, None], d, float(MASKED))
        idx = cids.to(torch.int32)[:, None] * L + local[None, :]
        best_d, best_i = _fold_tile(best_d, best_i, d, idx, k)
    return best_d, best_i


def _put3(arr, slots: np.ndarray, L: int, vals: torch.Tensor):
    """``arr`` ([C, L, ...] tensor, or a ``[R][S]`` grid of cluster blocks) with the
    entries of index ``slots`` set to ``vals`` (host tensors), copy on write: only the
    blocks a slot falls in are copied."""
    c_idx, l_idx = np.divmod(slots, L)
    if isinstance(arr, torch.Tensor):
        dev = arr.device
        return arr.clone().index_put_(
            (torch.from_numpy(c_idx).to(dev), torch.from_numpy(l_idx).to(dev)),
            vals.to(dev, arr.dtype))
    c_loc = arr[0][0].shape[0]
    shard = c_idx // c_loc
    out = [list(row) for row in arr]
    for s in np.unique(shard).tolist():
        sel = np.flatnonzero(shard == s)
        for row in out:
            dev = row[s].device
            row[s] = row[s].clone().index_put_(
                (torch.from_numpy(c_idx[sel] - s * c_loc).to(dev),
                 torch.from_numpy(l_idx[sel]).to(dev)),
                vals[torch.from_numpy(sel)].to(dev, row[s].dtype))
    return out


class IVFIndex:
    """Cluster-partitioned approximate index built from (and kept in step with) a
    NamespaceStore."""

    def __init__(self, store, n_clusters: Optional[int] = None,
                 cluster_capacity: Optional[int] = None, n_iters: int = 10, seed: int = 0,
                 spill: int = 1):
        """``spill``: place each vector in its ``spill`` nearest clusters (at most 4):
        spill x the index memory for higher recall at a fixed nprobe."""
        self.store = store
        # a sharded store's ShardingManager: the index is then cluster-sharded
        self._shm = getattr(store, "sharding", None)
        n = store.live_count
        if n < 2:
            raise ValueError("IVF needs at least 2 live vectors")
        self.spill = max(1, min(int(spill), 4))
        self._user_C = n_clusters
        self._user_L = cluster_capacity
        self._size(n)
        self.Dp = store.dpad
        self._slot_ids: List[Optional[uuid_mod.UUID]] = [None] * (self.C * self.L)
        self._id_to_slot: Dict[uuid_mod.UUID, int] = {}        # primary copy
        self._extra_slots: Dict[uuid_mod.UUID, List[int]] = {}  # spill copies (spill > 1)
        self._free_per_cluster: List[int] = [0] * self.C       # next free local index
        self._n_iters = n_iters
        self._seed = seed
        # drift: rows living in a cluster other than their nearest (overwrites that moved,
        # overflow placements) plus deleted copies; retrain() fires when drift / live
        # crosses the store's rebuild_threshold
        self._drift = 0
        self._build(n_iters, seed)

    # ------------------------------------------------------------------ build

    def _build(self, n_iters: int, seed: int) -> None:
        # host spans: device work a step leaves queued is counted by the next span that
        # reads the card (the assignment's copy to the host; the scatter's is nowhere)
        data, valid, sq_norms = self.store.device_state().gathered()
        with trace_span("ivf_build.kmeans"):
            self.centroids, _assign = train_kmeans(data, valid, self.C,
                                                   n_iters=n_iters, seed=seed)
            self.cnorms = (self.centroids * self.centroids).sum(-1)
        with trace_span("ivf_build.assign"):
            # copy 0 is the primary home, copies 1..spill-1 the spilled placements
            topm = assign_topm(data, valid, self.centroids, m=self.spill).cpu().numpy()
        with trace_span("ivf_build.layout"):
            vids = list(self.store._id_to_slot.keys())
            frm = np.fromiter(self.store._id_to_slot.values(), np.int64, len(vids))
            to, src, overflow = self._place_in_order(vids, topm[frm])
            if overflow:
                over = np.asarray(overflow)
                to = np.concatenate([to, self._place_overflow(data, frm[over],
                                                              [vids[i] for i in over])])
                src = np.concatenate([src, over])
        with trace_span("ivf_build.scatter"):
            arrays = self._cluster_arrays(data, sq_norms, to, frm[src])
        # one atomic publish: centroids, cluster arrays and slot table in one tuple
        self._gen = _IVFGen(self.centroids, self.cnorms, *arrays, self._slot_ids,
                            self.C, self.L)
        self.store_version = self.store.version

    def _place_in_order(self, vids: List[uuid_mod.UUID], cand: np.ndarray):
        """Place every id's copies into empty clusters as the JAX package's loop does, id
        by id and copy by copy: a copy takes the next free slot of its cluster; a primary
        (copy 0) whose cluster is full overflows, a spill copy whose cluster is full is
        dropped; an id with no cluster (-1) is skipped.  Per cluster that is the first L
        copies in (id, copy) order, so the slots come from one stable sort.  ``cand``:
        [n, spill] cluster ids.  Returns (index slots, id positions of the placed copies,
        in the loop's order; id positions of the overflowed primaries, in id order), with
        the slot table, id maps and fill counts updated."""
        m = cand.shape[1]
        ev = np.flatnonzero(np.repeat(cand[:, 0] >= 0, m))        # events in loop order
        c = cand.reshape(-1)[ev].astype(np.int64)
        by_cluster = np.argsort(c, kind="stable")
        cs = c[by_cluster]
        rank = np.empty_like(c)
        rank[by_cluster] = np.arange(len(cs)) - np.searchsorted(cs, cs, side="left")
        fits = rank < self.L
        pos, copy = ev // m, ev % m
        overflow = pos[~fits & (copy == 0)].tolist()
        ev_in = np.flatnonzero(fits)
        to = c[ev_in] * self.L + rank[ev_in]
        src = pos[ev_in]
        # object arrays from iterators: np.array() of a list of UUIDs probes each element
        vid_arr = np.fromiter(vids, dtype=object, count=len(vids))
        placed_vids = vid_arr[src]
        slot_ids = np.fromiter(self._slot_ids, dtype=object, count=len(self._slot_ids))
        slot_ids[to] = placed_vids
        self._slot_ids[:] = slot_ids.tolist()
        primary = copy[ev_in] == 0
        # the id maps in the loop's insertion order: primaries and spill copies in id order
        self._id_to_slot.update(zip(placed_vids[primary].tolist(), to[primary].tolist()))
        extra = ~primary
        for vid, slot in zip(placed_vids[extra].tolist(), to[extra].tolist()):
            self._extra_slots.setdefault(vid, []).append(slot)
        self._free_per_cluster = np.bincount(c[ev_in], minlength=self.C).tolist()
        return to, src, overflow

    def _place_overflow(self, data: torch.Tensor, rows: np.ndarray, vids) -> np.ndarray:
        """Place each overflowed primary, in id order, in the nearest cluster with space as
        the JAX package does: the first cluster with space in ``argsort`` of the f32
        ``((centroids - row) ** 2).sum(-1)`` computed in numpy.  That is the cluster with
        space whose f32 distance is smallest (on an exact tie, the one ``argsort`` puts
        first), and an f32 distance lies within (Dp + 4) * 2^-24 of the exact one, so only
        the clusters with space whose float64 distance (on the device) lies within that
        band of the smallest can be it: one left is the answer; else their f32 distances,
        computed as JAX computes them, decide; on an exact tie the row's whole argsort.
        Returns the index slots, in order."""
        cent32 = self.centroids.cpu().numpy()
        cent64 = self.centroids.double()
        band = (self.Dp + 4) * 2.0 ** -24 + 1e-12
        full = np.asarray(self._free_per_cluster) >= self.L
        slots = []
        for lo in range(0, len(rows), _OVERFLOW_BLOCK):
            block = data.index_select(0, torch.as_tensor(
                rows[lo : lo + _OVERFLOW_BLOCK], device=data.device))
            row32 = block.float().cpu().numpy()
            d64 = ((block.double()[:, None, :] - cent64[None]) ** 2).sum(-1).cpu().numpy()
            for row, d, vid in zip(row32, d64, vids[lo : lo + _OVERFLOW_BLOCK]):
                d = np.where(full, np.inf, d)
                best = d.min()
                if best == np.inf:  # pragma: no cover - only if totally full
                    raise RuntimeError("IVF capacity exhausted; increase cluster_capacity")
                cand = np.flatnonzero(d * (1 - band) <= best * (1 + band))
                if len(cand) > 1:
                    d32 = ((cent32[cand] - row[None, :]) ** 2).sum(-1)
                    cand = cand[d32 == d32.min()]
                if len(cand) > 1:
                    order = np.argsort(((cent32 - row[None, :]) ** 2).sum(-1))
                    cand = order[~full[order]][:1]
                c = int(cand[0])
                slots.append(self._place(c, vid))
                full[c] = self._free_per_cluster[c] >= self.L
        return np.asarray(slots, np.int64)

    def _cluster_arrays(self, data, sq_norms, to: np.ndarray, frm: np.ndarray):
        """(data3 [C, L, Dp] in the store's dtype, valid3 [C, L], sqn3 [C, L]) holding the
        store rows ``frm`` and their norms at index slots ``to``: one gather and scatter on
        the device; cluster-sharded into ``[R][S]`` grids over a sharded store."""
        dev = data.device
        data3 = torch.zeros((self.C * self.L, self.Dp), dtype=data.dtype, device=dev)
        valid3 = torch.zeros(self.C * self.L, dtype=torch.bool, device=dev)
        sqn3 = torch.zeros(self.C * self.L, dtype=torch.float32, device=dev)
        if len(to):
            to_t = torch.from_numpy(np.asarray(to, np.int64)).to(dev)
            frm_t = torch.from_numpy(np.asarray(frm, np.int64)).to(dev)
            data3[to_t] = data.index_select(0, frm_t)
            valid3[to_t] = True
            sqn3[to_t] = sq_norms.index_select(0, frm_t)
        out = (data3.view(self.C, self.L, self.Dp), valid3.view(self.C, self.L),
               sqn3.view(self.C, self.L))
        if self._shm is not None:
            return tuple(self._shm.place(t) for t in out)
        return out

    def _place(self, c: int, vid: uuid_mod.UUID, extra: bool = False) -> int:
        """Give ``vid`` the next free slot of cluster ``c``; returns the index slot."""
        i = self._free_per_cluster[c]
        self._free_per_cluster[c] = i + 1
        ivf_slot = c * self.L + i
        self._slot_ids[ivf_slot] = vid
        if extra:
            self._extra_slots.setdefault(vid, []).append(ivf_slot)
        else:
            self._id_to_slot[vid] = ivf_slot
        return ivf_slot

    # ------------------------------------------------------------------ maintenance

    def add(self, vectors: Sequence) -> None:
        """Incremental insert/overwrite keeping the index in step with the store."""
        if not vectors:
            return
        vals = np.zeros((len(vectors), self.Dp), np.float32)
        for i, v in enumerate(vectors):
            vals[i, : v.values.shape[0]] = v.values
        self._add_rows(vals, [v.id for v in vectors])

    def add_bulk(self, values: np.ndarray, ids: Sequence[uuid_mod.UUID]) -> None:
        """add() straight from a contiguous [n, dim] array (bulk_load's sync path, which
        builds no Vector per row)."""
        values = np.ascontiguousarray(values, np.float32)
        n = values.shape[0]
        if n == 0:
            return
        vals = np.zeros((n, self.Dp), np.float32)
        vals[:, : values.shape[1]] = values
        self._add_rows(vals, list(ids))

    def _add_rows(self, vals: np.ndarray, ids: List[uuid_mod.UUID]) -> None:
        dev = self.centroids.device
        topm = assign_topm(torch.from_numpy(vals).to(dev),
                           torch.ones(len(ids), dtype=torch.bool, device=dev),
                           self.centroids, m=self.spill).cpu().numpy()
        cent_np = self.centroids.cpu().numpy()
        slots: List[int] = []
        rows: List[int] = []

        def emit(slot, i):
            slots.append(slot)
            rows.append(i)

        for i, vid in enumerate(ids):
            old = self._id_to_slot.get(vid)
            if old is not None:
                # overwrite every copy in place; drift if now in the wrong cluster
                if old // self.L != int(topm[i, 0]):
                    self._drift += 1
                emit(old, i)
                for es in self._extra_slots.get(vid, ()):
                    emit(es, i)
            else:
                c = int(topm[i, 0])
                if self._free_per_cluster[c] >= self.L:
                    d = ((cent_np - vals[i][None, :]) ** 2).sum(-1)
                    for cc in np.argsort(d):
                        if self._free_per_cluster[int(cc)] < self.L:
                            c = int(cc)
                            break
                    else:  # pragma: no cover
                        raise RuntimeError("IVF full; rebuild with larger cluster_capacity")
                    self._drift += 1  # an overflow placement is not in its nearest cluster
                emit(self._place(c, vid), i)
                for j in range(1, self.spill):  # spill copies, best effort
                    cj = int(topm[i, j])
                    if cj >= 0 and self._free_per_cluster[cj] < self.L:
                        emit(self._place(cj, vid, extra=True), i)

        from .namespace import _last_write_wins

        # a batch repeating an id writes its slots twice: the last write lands (the
        # store's rule, ROADMAP C1), not whichever the scatter happens to apply last
        slots_np, rows_np = _last_write_wins(np.asarray(slots, np.int64), vals[rows])
        sq = (rows_np.astype(np.float64) ** 2).sum(-1).astype(np.float32)
        g = self._gen  # one generation in, one generation out (copy on write)
        self._gen = g._replace(  # atomic swap
            data3=_put3(g.data3, slots_np, self.L, torch.from_numpy(rows_np)),
            valid3=_put3(g.valid3, slots_np, self.L,
                         torch.ones(len(slots_np), dtype=torch.bool)),
            sqn3=_put3(g.sqn3, slots_np, self.L, torch.from_numpy(sq)))
        self.store_version = self.store.version
        self._maybe_retrain()

    def _maybe_retrain(self) -> None:
        """Retrain once drift / live crosses the store's rebuild_threshold (the IVF
        analogue of tombstone-triggered compaction)."""
        live = self.live_count
        if live >= 2 and self._drift / live >= self.store.config.rebuild_threshold:
            self.retrain()

    def _size(self, n: int) -> None:
        """(Re)derive the cluster count and capacity for an n-row corpus; user-pinned
        values win.  The capacity budgets ``spill`` copies of every row."""
        self.C = self._user_C or max(2, min(4096, int(np.sqrt(n) * 2)))
        if self._shm is not None:   # the cluster arrays split evenly over the shards
            s = self._shm.n_shards
            self.C = -(-self.C // s) * s
        avg = max(1, -(-(n * self.spill) // self.C))
        L = self._user_L or max(64, int(avg * 2.2))
        self.L = -(-L // 8) * 8

    def retrain(self) -> None:
        """Full re-cluster from the current store state; resets drift to zero and
        re-derives (C, L).  Built off to the side as a fresh index, then published: the
        store's ``ivf`` is swapped with a version bump (result caches drop the old
        index's answers), and this handle adopts the fresh state.  Readers holding an
        older generation keep probing one consistent layout."""
        fresh = IVFIndex(self.store, self._user_C, self._user_L, self._n_iters, self._seed,
                         self.spill)
        store = self.store
        with store._lock:
            if getattr(store, "ivf", None) is self:
                store.ivf = fresh
                store.version += 1  # nprobe answers changed: invalidate result caches
        self.__dict__.update(fresh.__dict__)

    def delete(self, ids: Sequence[uuid_mod.UUID]) -> None:
        slots = []
        for vid in ids:
            slot = self._id_to_slot.pop(vid, None)
            if slot is not None:
                self._slot_ids[slot] = None
                slots.append(slot)
                for es in self._extra_slots.pop(vid, ()):  # clear spill copies too
                    self._slot_ids[es] = None
                    slots.append(es)
        if slots:
            g = self._gen
            self._gen = g._replace(valid3=_put3(  # atomic swap
                g.valid3, np.asarray(slots, np.int64), self.L,
                torch.zeros(len(slots), dtype=torch.bool)))
            self._drift += len(slots)  # dead rows shrink the effective cluster capacity
        self.store_version = self.store.version
        self._maybe_retrain()

    # ------------------------------------------------------------------ search

    def search(self, q: torch.Tensor, k: int, metric: str, nprobe: int):
        """(dist [B, k], ivf_slot [B, k]); nprobe clamps to C (full probe = exact)."""
        d, i, _resolve = self.search_resolved(q, k, metric, nprobe)
        return d, i

    def search_resolved(self, q: torch.Tensor, k: int, metric: str, nprobe: int):
        """(dist, ivf_slot, resolver), the resolver bound to the generation that produced
        the slots, so a retrain between search and hydration cannot resolve old-layout
        slots against the new slot table."""
        g = self._gen  # ONE generation read; everything below derives from it
        probe = _ivf_search if self._shm is None else self._shm.sharded_ivf_probe
        d, i = probe(q, g.centroids, g.cnorms, g.data3, g.valid3, g.sqn3,
                     k=min(k, g.C * g.L), metric=metric, nprobe=max(1, min(nprobe, g.C)))
        return d, i, g.resolver()

    # read-only views of the published generation (stats, tests)
    @property
    def data3(self):
        return self._gen.data3

    @property
    def valid3(self):
        return self._gen.valid3

    @property
    def sqn3(self):
        return self._gen.sqn3

    def slot_to_id(self, slot: int) -> Optional[uuid_mod.UUID]:
        return self._gen.resolver()(int(slot))

    @property
    def live_count(self) -> int:
        return len(self._id_to_slot)

    def stats(self) -> Dict[str, float]:
        fills = np.asarray(self._free_per_cluster)
        live = self.live_count
        g = self._gen
        return {
            "clusters": self.C,
            "cluster_capacity": self.L,
            "live": live,
            "spill": self.spill,
            "copies": live + sum(len(v) for v in self._extra_slots.values()),
            "fill_mean": float(fills.mean()),
            "fill_max": int(fills.max()),
            "drift": self._drift,
            "drift_ratio": self._drift / live if live else 0.0,
            # one copy of the index (a sharded index: one replica's blocks)
            "memory_bytes": int(sum(t.numel() * t.element_size()
                                    for a in (g.data3, g.valid3, g.sqn3)
                                    for t in ([a] if isinstance(a, torch.Tensor) else a[0]))),
            "sharded": self._shm is not None,
            "shards": 1 if self._shm is None else self._shm.n_shards,
        }

    # ------------------------------------------------------------------ persistence

    def snapshot_arrays(self) -> Dict[str, object]:
        """Checkpoint payload in the JAX package's format: the centroids and the cluster
        layout.  The cluster-major copies are not written; they are rebuilt from the
        store's rows at load time (the same layout, hence the same answers)."""
        # primaries before spill copies, so from_snapshot's first-occurrence rule
        # reconstructs the same primary/extra split
        primaries = sorted(self._id_to_slot.items(), key=lambda kv: kv[1])
        extras = [(vid, s) for vid, ss in self._extra_slots.items() for s in ss]
        ordered = [(s, vid) for vid, s in primaries] + [(s, vid) for vid, s in extras]
        return {
            "C": self.C,
            "L": self.L,
            "spill": self.spill,
            "drift": self._drift,
            "n_iters": self._n_iters,
            "seed": self._seed,
            "user_C": self._user_C,
            "user_L": self._user_L,
            "centroids": self.centroids.cpu().numpy().astype(np.float32),
            "slots": [s for s, _vid in ordered],
            "ids": [str(vid) for _s, vid in ordered],
        }

    @classmethod
    def from_snapshot(cls, store, snap: Dict[str, object]) -> "IVFIndex":
        """Rebuild the index around a restored store without retraining: centroids and
        every id -> cluster-slot placement come from the snapshot, the rows from the
        store."""
        ivf = cls.__new__(cls)
        ivf.store = store
        ivf.C = int(snap["C"])
        ivf._shm = getattr(store, "sharding", None)
        if ivf._shm is not None and ivf.C % ivf._shm.n_shards:
            # saved under another mesh: C does not split over this one's shards, so this
            # index runs unsharded (the next retrain derives a shardable C)
            ivf._shm = None
        ivf.L = int(snap["L"])
        ivf.Dp = store.dpad
        ivf.spill = int(snap.get("spill", 1))
        ivf._user_C = snap.get("user_C")
        ivf._user_L = snap.get("user_L")
        ivf._n_iters = int(snap.get("n_iters", 10))
        ivf._seed = int(snap.get("seed", 0))
        ivf._drift = int(snap.get("drift", 0))
        data, _valid, sq_norms = store.device_state().gathered()
        ivf.centroids = torch.from_numpy(
            np.array(snap["centroids"], np.float32)).to(data.device)
        ivf.cnorms = (ivf.centroids * ivf.centroids).sum(-1)
        ivf._slot_ids = [None] * (ivf.C * ivf.L)
        ivf._id_to_slot = {}
        ivf._extra_slots = {}
        ivf._free_per_cluster = [0] * ivf.C
        to: List[int] = []
        frm: List[int] = []
        for ivf_slot, sid in zip(snap["slots"], snap["ids"]):
            vid = uuid_mod.UUID(sid)
            store_slot = store._id_to_slot.get(vid)
            if store_slot is None:  # the snapshot raced a delete: drop the orphan
                continue
            ivf_slot = int(ivf_slot)
            c, i = divmod(ivf_slot, ivf.L)
            ivf._slot_ids[ivf_slot] = vid
            if vid in ivf._id_to_slot:  # later occurrences are spill copies
                ivf._extra_slots.setdefault(vid, []).append(ivf_slot)
            else:
                ivf._id_to_slot[vid] = ivf_slot
            ivf._free_per_cluster[c] = max(ivf._free_per_cluster[c], i + 1)
            to.append(ivf_slot)
            frm.append(store_slot)
        ivf._gen = _IVFGen(ivf.centroids, ivf.cnorms,
                           *ivf._cluster_arrays(data, sq_norms, to, frm),
                           ivf._slot_ids, ivf.C, ivf.L)
        ivf.store_version = store.version
        return ivf

