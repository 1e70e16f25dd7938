"""Sharded namespace store: one namespace spread over the mesh, the counterpart of
``mlvectordb_tpu/parallel/store.py``.

Slot layout, the JAX package's: ``slot = shard * shard_capacity + local``.  Every shard
keeps an equal slot range; an id's slot is allocated in the range of its owner shard
(``ShardingManager.shard_for_id``) from that shard's free list, then its high-water
mark.  Snapshots, the write-ahead log, hydration and ``convert`` see the same global
slots as the JAX package, so each package loads the other's sharded snapshot.

Device state: for every (replica, shard) cell of the mesh, the shard's rows
``[shard_capacity, dim_padded]``, liveness and squared norms on the cell's device, and
the sweep arrays of the port's certified sweep where the configuration keeps them: a
bf16 mirror with its per-row ``sweep_err`` (an f32 store under ``sweep_dtype="bfloat16"``;
no residual stream, as in the JAX package's sharded store), an f32 mirror of a bf16
shard's rows (no certificate arrays: write upkeep copies the written values, a rebuild
widens the rows, as the JAX package's sharded store does), or the rows themselves (a
mirror of the rows' own type).  An int8 ``sweep_dtype`` runs without a mirror (the masked
row-major kernel per shard), as the JAX package's sharded store does.  A snapshot
(``ShardedState``) holds one per-shard ``DeviceState`` per cell, each with its own prep
dict: prep is query-independent but shard-dependent.

Writes and deletes fan out to every replica's tensors of the owner shard (the JAX
package gets this from XLA); each publish is copy-on-write, as the unsharded store's.
Capacity grows per shard: every shard is sized for the worst case, all new ids of a
batch hashing to it, and grows by padding its own region (its local slots keep their
place).  The free space counted for that check is the real one: the JAX package also
counts the regrown range a second time, which can hand out a slot twice (ROADMAP C12).
"""

from __future__ import annotations

import uuid as uuid_mod
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, EngineConfig
from ..ops.fused_knn_t import SWEEP_TILE, sweep_err_norms
from ..store.namespace import (DeviceState, NamespaceStore, _clear_slots, _grow,
                               _scatter_mirror, _scatter_rows, _scatter_sweep_err,
                               _storage_dtype)
from .sharding import ShardingManager


class ShardedState(NamedTuple):
    """Snapshot of a sharded namespace: ``shards[r][s]`` is the DeviceState of replica r's
    shard s, on that cell's device.  ``data`` / ``valid`` are the ``[R][S]`` grids of its
    rows and liveness (what ``ReplicationManager.reconcile`` takes)."""

    shards: tuple
    high_water: int
    live_count: int
    host_tables: Optional[tuple]
    capacity: int

    @property
    def data(self):
        return [[st.data for st in row] for row in self.shards]

    @property
    def valid(self):
        return [[st.valid for st in row] for row in self.shards]

    def gathered(self):
        """Replica 0's (data, valid, sq_norms) over every global slot, concatenated on
        its first shard's device."""
        dev = self.shards[0][0].data.device
        return tuple(torch.cat([getattr(st, f).to(dev) for st in self.shards[0]])
                     for f in ("data", "valid", "sq_norms"))


class _Cell:
    """One (replica, shard) cell's device arrays."""

    __slots__ = ("device", "data", "valid", "sq_norms", "mirror", "sweep_err")

    def __init__(self, device, data=None, valid=None, sq_norms=None):
        self.device = device
        self.data, self.valid, self.sq_norms = data, valid, sq_norms
        self.mirror = self.sweep_err = None

    def arrays(self):
        return (self.data, self.valid, self.sq_norms, self.mirror, self.sweep_err)


class ShardedNamespaceStore(NamespaceStore):
    """NamespaceStore whose device state is split over a mesh's shards and replicated over
    its replicas."""

    def __init__(
        self,
        name: str,
        sharding_manager: ShardingManager,
        config: EngineConfig = DEFAULT_CONFIG,
    ):
        super().__init__(name, config, device=sharding_manager.mesh.home)
        self.sharding = sharding_manager
        self.n_shards = sharding_manager.n_shards
        self.n_replicas = sharding_manager.n_replicas
        self.shard_capacity = 0
        # per-shard allocation state (the base class's free list is unused)
        self._shard_free: List[List[int]] = [[] for _ in range(self.n_shards)]
        self._shard_high: List[int] = [0] * self.n_shards
        # the high-water mark's bound: locals past it came from a regrow and sit in the
        # free list (or are taken), never behind the mark
        self._shard_end: List[int] = [0] * self.n_shards
        self._cells: Optional[List[List[_Cell]]] = None   # [R][S]; None: empty/offloaded

    # ------------------------------------------------------------------ sweep arrays

    @staticmethod
    def _shard_mirror_ok(c: int) -> bool:
        """The mirror is shard-local: every shard must hold whole SWEEP_TILE-row tiles."""
        return c >= SWEEP_TILE and c % SWEEP_TILE == 0

    def _mirror_kind(self) -> Optional[str]:
        """"bf16" (a mirror of its own with sweep_err), "f32" (an f32 mirror of bf16
        rows), "rows" (the rows are the mirror) or None (int8, no sweep_dtype, or shards
        too small)."""
        sdt = self.config.sweep_dtype
        if sdt is None or self._int8_sweep() or not self._shard_mirror_ok(self.shard_capacity):
            return None
        if self._rows_are_mirror():
            return "rows"
        return "bf16" if self._mixed_sweep() else "f32"

    def _build_cell_sweep(self, cell: _Cell) -> None:
        """(Re)build a cell's mirror and sweep_err from its rows."""
        cell.mirror = cell.sweep_err = None
        kind = self._mirror_kind()
        if kind == "bf16":
            cell.mirror = cell.data.to(torch.bfloat16)
            cell.sweep_err = sweep_err_norms(cell.data)
        elif kind == "f32":
            cell.mirror = cell.data.float()

    def _cell_state(self, cell: _Cell, s: int) -> DeviceState:
        kind = self._mirror_kind()
        mirror = cell.data if kind == "rows" else cell.mirror if kind else None
        # the per-shard search is always masked: high_water is the shard's own mark and
        # no live count is kept per shard
        return DeviceState(cell.data, cell.valid, cell.sq_norms, self._shard_high[s], -1,
                           mirror, cell.sweep_err, prep_cache={})

    # ------------------------------------------------------------------ snapshots

    @property
    def nbytes(self) -> int:
        """Device bytes of every cell (replicas counted each), or the host copy's while
        offloaded."""
        if self._cells is None:
            if self._offloaded is not None:
                return sum(t.numel() * t.element_size()
                           for ts in self._offloaded.values() for t in ts)
            return 0
        return sum(t.numel() * t.element_size() for row in self._cells for cell in row
                   for t in cell.arrays() if t is not None)

    def _publish(self) -> None:
        self._state = ShardedState(
            tuple(tuple(self._cell_state(cell, s) for s, cell in enumerate(row))
                  for row in self._cells),
            self._high_water, len(self._id_to_slot),
            (self._slot_ids, self._slot_meta, self._slot_values), self.capacity)

    def offload(self) -> bool:
        """Replica 0's rows, liveness and norms to host tensors; every cell's device
        arrays dropped (replicas are restored from that one copy, as the JAX package's
        replicated arrays are)."""
        with self._lock:
            if self._cells is None or self._offloaded is not None:
                return False
            row = self._cells[0]
            self._offloaded = {f: [getattr(c, f).cpu() for c in row]
                               for f in ("data", "valid", "sq_norms")}
            self._cells = None
            self._state = None
            return True

    def ensure_resident(self) -> bool:
        with self._lock:
            if self._offloaded is None:
                return False
            host = self._offloaded
            self._cells = [[_Cell(dev, *(host[f][s].to(dev, copy=True)
                                         for f in ("data", "valid", "sq_norms")))
                            for s, dev in enumerate(row)]
                           for row in self.sharding.mesh.devices]
            for row in self._cells:
                for cell in row:
                    self._build_cell_sweep(cell)
            self._offloaded = None
            self._publish()
            return True

    # ------------------------------------------------------------------ allocation

    def _growth(self, extra: int) -> Optional[int]:
        """The per-shard capacity making room for ``extra`` new ids if any one shard
        could overflow (all of them hashing to it), else None (JAX store.py:187-205)."""
        if self._cells is not None or self._offloaded is not None:
            worst_free = min(len(free) + (end - high) for free, high, end in
                             zip(self._shard_free, self._shard_high, self._shard_end))
            if extra <= worst_free:
                return None
            # JAX's target, or more where taken slots lie past the high-water mark
            needed = max(max(self._shard_high) + extra,
                         self.shard_capacity + extra - worst_free)
        else:
            needed = extra
        per = self.config.round_capacity(
            max(needed, self.config.initial_capacity // self.n_shards + 1))
        p = self.config.capacity_multiple
        return -(-max(p, per) // p) * p

    def _check_capacity(self, fresh: int) -> None:
        per = self._growth(fresh)
        if per is not None and per * self.n_shards > self.config.max_capacity:
            raise MemoryError(
                f"namespace {self.name!r} would exceed max_capacity={self.config.max_capacity}"
            )

    def _ensure_capacity(self, extra: int) -> None:
        per = self._growth(extra)
        if per is None:
            return
        if per * self.n_shards > self.config.max_capacity:
            raise MemoryError(
                f"namespace {self.name!r} would exceed max_capacity={self.config.max_capacity}"
            )
        self._alloc_arrays(per * self.n_shards)
        self._grow_host_tables(self.capacity)

    def _alloc_arrays(self, new_cap: int) -> None:
        """Create, or grow every shard's region in place to, ``new_cap / S`` rows."""
        p = self.config.capacity_multiple
        per = -(-max(p, -(-new_cap // self.n_shards)) // p) * p
        dtype = _storage_dtype(self.config)
        old = self.shard_capacity
        if self._cells is None:
            self.shard_capacity = per
            self._cells = [[_Cell(dev, torch.zeros((per, self.dpad), dtype=dtype, device=dev),
                                  torch.zeros((per,), dtype=torch.bool, device=dev),
                                  torch.zeros((per,), dtype=torch.float32, device=dev))
                            for dev in row] for row in self.sharding.mesh.devices]
            for row in self._cells:
                for cell in row:
                    self._build_cell_sweep(cell)
            self._shard_end = [per] * self.n_shards
            self.capacity = per * self.n_shards
            return
        grow = per - old
        had_mirror = self._mirror_kind() in ("bf16", "f32")
        self.shard_capacity = per
        for row in self._cells:
            for cell in row:
                cell.data, cell.valid, cell.sq_norms = (
                    _grow(t, grow) for t in (cell.data, cell.valid, cell.sq_norms))
                if had_mirror:   # zero rows: bf16(0) = 0 with a zero bound
                    cell.mirror, cell.sweep_err = (None if t is None else _grow(t, grow)
                                                   for t in (cell.mirror, cell.sweep_err))
                else:
                    self._build_cell_sweep(cell)
        self.capacity = per * self.n_shards
        # remap the host tables: slot shard*old + local -> shard*per + local
        pad = [None] * grow

        def regrown(table):
            out = []
            for s in range(self.n_shards):
                out.extend(table[s * old:(s + 1) * old])
                out.extend(pad)
            return out

        self._slot_ids = regrown(self._slot_ids)
        self._slot_meta = regrown(self._slot_meta)
        self._slot_values = regrown(self._slot_values)
        self._id_to_slot = {vid: (s // old) * per + s % old
                            for vid, s in self._id_to_slot.items()}
        self._rebuild_meta_columns()   # slots moved: the native metadata columns too
        # JAX's order: the regrown range, then the old free slots (popped first)
        self._shard_free = [
            [sh * per + loc for loc in range(old, per)]
            + [sh * per + (f - sh * old) for f in free]
            for sh, free in enumerate(self._shard_free)
        ]

    def _alloc_slot(self, vid: uuid_mod.UUID) -> int:
        sh = self.sharding.shard_for_id(vid)
        if self._shard_free[sh]:
            return self._shard_free[sh].pop()
        loc = self._shard_high[sh]
        if loc >= self._shard_end[sh]:
            # _ensure_capacity sizes for the all-ids-hash-to-one-shard worst case before
            # any slot is handed out, so this cannot happen mid-batch
            raise RuntimeError(
                f"shard {sh} overflow in namespace {self.name!r} (capacity invariant broken)"
            )
        self._shard_high[sh] = loc + 1
        self._high_water = sum(self._shard_high)  # keeps rebuild_required's ratio meaningful
        return sh * self.shard_capacity + loc

    def _free_slot(self, slot: int) -> None:
        self._shard_free[slot // self.shard_capacity].append(slot)

    # ------------------------------------------------------------------ mutation

    def _by_shard(self, slots: np.ndarray):
        """(shard, positions of ``slots`` in it, their local slots) per shard touched."""
        sh, loc = np.divmod(np.asarray(slots, np.int64), self.shard_capacity)
        for s in np.unique(sh).tolist():
            pos = np.flatnonzero(sh == s)
            yield s, pos, loc[pos]

    def _scatter_write(self, slots: np.ndarray, vals: np.ndarray) -> None:
        """Apply a write batch to every replica of each owner shard: one copy of the
        shard's slots and rows to each distinct device."""
        for s, pos, loc in self._by_shard(slots):
            sent = {}
            for row in self._cells:
                cell = row[s]
                if cell.device not in sent:
                    sent[cell.device] = (torch.from_numpy(loc).to(cell.device),
                                         torch.from_numpy(vals[pos]).to(cell.device))
                loc_t, vals_t = sent[cell.device]
                cell.data, cell.valid, cell.sq_norms = _scatter_rows(
                    cell.data, cell.valid, cell.sq_norms, loc_t, vals_t)
                if cell.mirror is not None:
                    cell.mirror = _scatter_mirror(cell.mirror, loc_t, vals_t)
                if cell.sweep_err is not None:
                    cell.sweep_err = _scatter_sweep_err(cell.sweep_err, loc_t, vals_t)

    def _clear_device(self, slots: List[int]) -> None:
        for s, _pos, loc in self._by_shard(np.asarray(slots, np.int64)):
            for row in self._cells:
                cell = row[s]
                cell.valid = _clear_slots(cell.valid, torch.from_numpy(loc).to(cell.device))

    # ------------------------------------------------------------------ compaction

    def compact(self) -> None:
        """Per-shard repack: rebuild as a fresh sharded store and swap its state in."""
        with self._lock:
            old_version = self.version
            vectors = self.all_vectors()
            fresh = ShardedNamespaceStore(self.name, self.sharding, self.config)
            if self.dim is not None:
                fresh._ensure_dim(self.dim)
            if vectors:
                fresh.upsert(vectors)
            keep = ("_lock", "name", "config", "sharding", "ivf", "incarnation")
            # the IVF index keys by uuid over its own cluster-major copies, so a slot
            # repack cannot stale it
            self.__dict__.update({k: v for k, v in fresh.__dict__.items() if k not in keep})
            self._tombstones = 0
            # monotonic across the swap: fresh's counter starts at 0 and could collide
            # with a pre-compaction version, resurrecting cache entries keyed by it
            self.version = max(old_version, self.version) + 1
            if self._cells is not None:
                self._publish()
            else:
                self._state = None

    # ------------------------------------------------------------------ repair

    def reconcile_and_repair(self, rm) -> Dict[str, Any]:
        """Verify replica consistency and, on divergence, restore it on the devices:
        the majority replica's rows and liveness copied to every member, then the norms
        recomputed from the rows (f32 sums, the JAX package's rule), the sweep arrays
        rebuilt, and a new snapshot published.  Returns the repair report."""
        with self._lock:
            if self._cells is None:
                return {"consistent": True, "repaired": False}
            grid = lambda f: [[getattr(c, f) for c in row] for row in self._cells]
            data2, valid2, report = rm.repair(grid("data"), grid("valid"))
            if report.get("repaired"):
                for r, row in enumerate(self._cells):
                    for s, cell in enumerate(row):
                        cell.data, cell.valid = data2[r][s], valid2[r][s]
                        d32 = cell.data.float()
                        cell.sq_norms = (d32 * d32).sum(-1)
                        self._build_cell_sweep(cell)
                self.version += 1
                self._publish()
            return report

    # ------------------------------------------------------------------ persistence

    def snapshot_arrays(self) -> Dict[str, Any]:
        """The JAX package's snapshot format (live rows in global slot order) from
        replica 0's shards, or from the host copy while offloaded."""
        with self._lock:
            live = sorted(self._id_to_slot.items(), key=lambda kv: kv[1])
            if live and (self._cells is not None or self._offloaded is not None):
                slots = np.asarray([s for _, s in live], np.int64)
                parts = []
                for s, _pos, loc in self._by_shard(slots):
                    src = (self._cells[0][s].data if self._offloaded is None
                           else self._offloaded["data"][s])
                    idx = torch.from_numpy(loc).to(src.device)
                    parts.append(src.index_select(0, idx)[:, : self.dim].float().cpu())
                rows = torch.cat(parts).numpy()
            else:
                rows = np.zeros((0, self.dim or 0), np.float32)
            return {
                "name": self.name,
                "dim": self.dim,
                "ids": [str(vid) for vid, _ in live],
                "values": rows,
                "metadata": [self._slot_meta[s] for _, s in live],
            }

    # ------------------------------------------------------------------ search

    def sharded_search(self, q: torch.Tensor, k: int, metric: str, valid_override=None, *,
                       state: Optional[ShardedState] = None, prep=None,
                       n_live: Optional[int] = None, defer: bool = False):
        """(dist [B, k], global slot idx [B, k]) through the cross-shard merge.

        ``valid_override``: a [capacity] bool tensor (liveness AND a filter's mask, the
        JAX package's form), split here over the shards, or an ``[R][S]`` grid already
        on the cells' devices (then ``prep`` may give each cell's prep dict for it).
        ``state``: the snapshot to search (default: the published one)."""
        st = self.device_state() if state is None else state
        valid = valid_override
        if isinstance(valid_override, torch.Tensor):
            c = st.capacity // self.n_shards
            valid = [[valid_override[s * c:(s + 1) * c].to(cell.data.device)
                      for s, cell in enumerate(row)] for row in st.shards]
        return self.sharding.sharded_knn(
            q, st.shards, k=k, metric=metric, n_live=n_live, valid=valid, prep=prep,
            db_tile=self.config.db_tile, defer=defer)
