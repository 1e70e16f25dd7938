"""Per-namespace device store: the counterpart of ``mlvectordb_tpu/store/namespace.py``.

Device state (capacity grows in powers of two):
  data     [capacity, dim_padded]  float32, or bfloat16 under config.dtype="bfloat16"
                                   (the written f32 rows rounded); lane-padded with zeros
  valid    [capacity]              bool — False = never-written, tombstoned, or freed slot
  sq_norms [capacity]              f32  — squared norms: of the written f32 rows, and after
                                   a compaction of the stored rows (the JAX package's rule)
With a ``sweep_dtype`` (the certified sweep, ops/fused_knn_t), beside them a ROW-major
sweep mirror [capacity, dim_padded] (the JAX package's is window-major [dpad, cap]; see
fused_knn_t) and the certificate's per-row arrays:
  "bfloat16": mirror bf16;  sweep_err [capacity] f32, the data-side bound per row; with
              config.sweep_resid, sweep_resid [capacity, dim_padded] int8 codes of
              row - bf16(row), their scales sweep_rscale and the raw norms sweep_err1
  "int8":     mirror int8 codes z1 with the dequant scales sweep_rscale (s1) and
              sweep_err = ||row - s1*z1||; with config.sweep_resid, the second stream
              sweep_resid (z2) with its scales sweep_rscale2 (s2), sweep_err =
              ||row - s1*z1 - s2*z2|| and sweep_err1 = ||row - s1*z1||
  "float32":  over an f32 store the mirror IS data: the row-major f32 mirror would hold
              the same bytes in the same layout, so the store keeps one tensor (the JAX
              package keeps a transposed copy); over a bf16 store it is a tensor of its
              own, with no certificate arrays (as in the JAX package)
Over a bf16 store (config.dtype="bfloat16") the bf16 mirror is data itself for the same
reason (the same-dtype sweep: no certificate arrays).  An int8 or f32 mirror of a bf16
store holds what the JAX package's holds: write upkeep codes or copies the written f32
values, a whole rebuild (first mirror-eligible capacity, compaction, page-in) the stored
bf16 rows, so until a compaction its rows differ from the rows the rescan scores
(fused_knn_t measures the certificate's bound rows against the stored rows: ROADMAP C13).

Host state: slot -> uuid / metadata / float32 values, uuid -> slot map, free-slot stack,
and, where the native library builds, ``meta_columns``: the slot-aligned columnar copy of
the metadata that filter masks are evaluated on (native.MetaColumns), kept in step with
every write, delete, growth and compaction.  Hydration returns the written f32 values,
whatever the storage dtype.  Writes scatter into free slots (upsert by id overwrites in
place); deletes clear the mask.  Compaction repacks live rows and is strictly
per-namespace.

Offload (``offload`` / ``ensure_resident``): a cold namespace moves data, valid and
sq_norms to host tensors and drops every device array, the mirror and the certificate
arrays included, so its device memory is freed; host-table reads keep working, and the
first search or write pages it back in, rebuilding the sweep arrays from the rows and
publishing a new snapshot.  Neither bumps the version.
"""

from __future__ import annotations

import threading
import uuid as uuid_mod
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, EngineConfig
from ..ops.fused_knn_t import (SWEEP_TILE, quantize_int8_resid_rows, quantize_int8_rows,
                               quantize_resid_rows, row_sq_norms, sweep_err_norms)
from .vector import Vector


def _storage_dtype(config: EngineConfig) -> torch.dtype:
    """The rows' device type (JAX namespace.py:347-348): bf16 only when asked for."""
    return torch.bfloat16 if config.dtype == "bfloat16" else torch.float32


class DeviceState(NamedTuple):
    """Snapshot of the searchable device arrays.  Writers replace the tensors (copy on
    write) instead of updating them, so a search holding this tuple is isolated from
    concurrent writers."""

    data: torch.Tensor      # [cap, dpad]
    valid: torch.Tensor     # [cap] bool
    sq_norms: torch.Tensor  # [cap] f32
    # Host counters captured at publish time.  Readers deriving the live-prefix fast
    # path MUST use these, not the store's live attributes: an upsert bumps
    # _high_water before the device scatter publishes, so pairing an old data
    # snapshot with the live _high_water would admit never-written all-zero rows
    # into top-k.
    high_water: int
    live_count: int
    # Row-major sweep mirror and the certificate's per-row arrays (config.sweep_dtype;
    # see the module docstring), or None.  A mirror of the rows' own type is ``data``.
    mirror: Optional[torch.Tensor] = None
    sweep_err: Optional[torch.Tensor] = None
    sweep_resid: Optional[torch.Tensor] = None
    sweep_rscale: Optional[torch.Tensor] = None
    sweep_err1: Optional[torch.Tensor] = None
    sweep_rscale2: Optional[torch.Tensor] = None
    # Host slot tables (ids, metadata, values) captured at publish time: hydration
    # reads all three from here, one atomic tuple, because compact() replaces the
    # lists wholesale.
    host_tables: Optional[tuple] = None
    # Per-snapshot cache of query-independent search prep (fused_knn_t._prep_terms),
    # keyed by (metric, plan): a fresh dict per publish, since the arrays are valid for
    # this snapshot's data only.
    prep_cache: Optional[dict] = None

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    def gathered(self):
        """(data, valid, sq_norms) over every slot, on one device (the sharded snapshot,
        parallel/store.py, concatenates its shards here)."""
        return self.data, self.valid, self.sq_norms


# Copy-on-write (clone + index_put_), as the JAX package does: a search dispatched a
# moment earlier may still read the old tensors.  Writing in place under CUDA streams
# is a later, tested decision.
def _scatter_rows(data, valid, sq_norms, slots, vals):
    """Device-side upsert: scatter rows + norms, set liveness (copy-on-write)."""
    vals32 = vals.float()
    data = data.clone().index_put_((slots,), vals32.to(data.dtype))
    sq_norms = sq_norms.clone().index_put_((slots,), (vals32 * vals32).sum(-1))
    valid = valid.clone().index_put_((slots,), torch.ones_like(slots, dtype=torch.bool))
    return data, valid, sq_norms


def _scatter_mirror(mirror, slots, vals):
    """Sweep-mirror upkeep: the written rows in the mirror's type, a bf16 mirror's
    rounded, an f32 mirror's as written (copy-on-write)."""
    return mirror.clone().index_put_((slots,), vals.float().to(mirror.dtype))


def _scatter_sweep_err(err, slots, vals):
    """Per-row ||row - bf16(row)|| for the certificate, when no residual codes are kept."""
    return err.clone().index_put_((slots,), sweep_err_norms(vals))


def _scatter_int8(mirror, rscale, err, slots, vals):
    """The int8 primary mirror: the written rows' codes, scales and error norms
    (copy-on-write)."""
    z, s, e = quantize_int8_rows(vals)
    return (mirror.clone().index_put_((slots,), z), rscale.clone().index_put_((slots,), s),
            err.clone().index_put_((slots,), e))


def _scatter_int8_resid(mirror, rscale, resid, rscale2, err, err1, slots, vals):
    """The two-level int8 mirror: both code streams of the written rows, their scales and
    error norms, in one quantization (copy-on-write)."""
    out = quantize_int8_resid_rows(vals)
    return tuple(t.clone().index_put_((slots,), v)
                 for t, v in zip((mirror, rscale, resid, rscale2, err, err1), out))


def _scatter_resid(err, err1, rscale, resid, slots, vals):
    """The int8 residual codes, their scales and both error norms of the written rows,
    in one quantization (copy-on-write)."""
    z, scale, e2, e1 = quantize_resid_rows(vals)
    return (
        err.clone().index_put_((slots,), e2),
        err1.clone().index_put_((slots,), e1),
        rscale.clone().index_put_((slots,), scale),
        resid.clone().index_put_((slots,), z),
    )


def _clear_slots(valid, slots):
    """Device-side delete: tombstone = mask clear (copy-on-write)."""
    return valid.clone().index_put_((slots,), torch.zeros_like(slots, dtype=torch.bool))


def _grow(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with ``rows`` zero rows appended along the first axis."""
    return torch.cat([t, t.new_zeros((rows, *t.shape[1:]))])


class NamespaceStore:
    """One namespace's vectors, device-resident and exactly searchable."""

    def __init__(self, name: str, config: EngineConfig = DEFAULT_CONFIG, *, device="cuda"):
        self.name = name
        self.config = config
        self.device = torch.device(device)
        self._lock = threading.RLock()
        # Incarnation token: version numbers restart at 0 when a namespace is GC'd and
        # recreated under the same name, so (name, version) cache keys must include this.
        self.incarnation = uuid_mod.uuid4().hex

        self.dim: Optional[int] = None   # logical dim, fixed at first write
        self.dpad: int = 0
        self.capacity: int = 0

        self._data: Optional[torch.Tensor] = None
        self._valid: Optional[torch.Tensor] = None
        self._sq_norms: Optional[torch.Tensor] = None
        # the sweep mirror and its arrays (module docstring); None for a mirror of the
        # rows' own type, which is _data itself (_sweep_mirror)
        self._mirror: Optional[torch.Tensor] = None        # [cap, dpad] bf16, int8 or f32
        self._sweep_err: Optional[torch.Tensor] = None     # [cap] certificate bound
        self._sweep_resid: Optional[torch.Tensor] = None   # [cap, dpad] int8 residual codes
        self._sweep_rscale: Optional[torch.Tensor] = None  # [cap] their (bf16) or z1's scales
        self._sweep_err1: Optional[torch.Tensor] = None    # [cap] raw residual norms
        self._sweep_rscale2: Optional[torch.Tensor] = None  # [cap] z2's scales (int8)
        # atomically-published snapshot tuple: readers never assemble a state from the
        # individual attributes
        self._state: Optional[DeviceState] = None

        # slot-indexed host tables
        self._slot_ids: List[Optional[uuid_mod.UUID]] = []
        self._slot_meta: List[Optional[Dict[str, Any]]] = []
        self._slot_values: List[Optional[np.ndarray]] = []   # float32, unpadded
        self._id_to_slot: Dict[uuid_mod.UUID, int] = {}
        self._free: List[int] = []
        self._high_water = 0          # slots ever used (never reused slots beyond this)
        self._tombstones = 0          # deletes since last compaction
        self.version = 0              # bumped on every mutation (result-cache key)
        # native columnar metadata mirror (filters); stood up lazily at the first write,
        # None without a toolchain or once some metadata is not representable natively
        self.meta_columns = None
        self._meta_columns_tried = False
        # host copies of data / valid / sq_norms while offloaded (offload()), else None
        self._offloaded: Optional[Dict[str, torch.Tensor]] = None
        # optional approximate index (store/ivf.py), attached by QueryProcessor.build_ivf
        self.ivf = None

    # ------------------------------------------------------------------ properties

    @property
    def live_count(self) -> int:
        return len(self._id_to_slot)

    @property
    def nbytes(self) -> int:
        """Exact device-array byte accounting: data + valid + sq_norms, and the sweep
        mirror and its certificate arrays when kept (a mirror of the rows' own type is
        data, counted once; an f32 mirror of bf16 rows is a tensor of its own)."""
        if self._data is None:
            # an offloaded namespace holds no device memory: count its host copy
            if self._offloaded is not None:
                return sum(t.numel() * t.element_size() for t in self._offloaded.values())
            return 0
        total = self.capacity * (self.dpad * self._data.element_size() + 1 + 4)
        for t in self._sweep_arrays():
            if t is not None:
                total += t.numel() * t.element_size()
        return total

    def _sweep_arrays(self):
        return (self._mirror, self._sweep_err, self._sweep_resid, self._sweep_rscale,
                self._sweep_err1, self._sweep_rscale2)

    def _rows_are_mirror(self) -> bool:
        """The mirror is of the rows' own type (the f32 mirror of an f32 store, the bf16
        mirror of a bf16 store): the row store itself serves as the mirror."""
        return self.config.sweep_dtype == self.config.dtype

    def _sweep_mirror(self) -> Optional[torch.Tensor]:
        """The mirror a search reads: the row store itself for a mirror of the rows' own
        type, whenever the capacity takes the sweep layout; else the mirror tensor."""
        if (self._rows_are_mirror() and self._data is not None
                and self._mirror_ok(self._data.shape[0])):
            return self._data
        return self._mirror

    @property
    def ids(self) -> List[uuid_mod.UUID]:
        return list(self._id_to_slot.keys())

    def device_state(self) -> DeviceState:
        state = self._state  # single attribute read = atomic under the GIL
        if state is None:
            if self._offloaded is not None:
                self.ensure_resident()
                state = self._state
            if state is None:
                raise ValueError(f"namespace {self.name!r} is empty")
        return state

    def _publish(self) -> None:
        """Swap in a new consistent (data, valid, sq_norms, counters) generation."""
        self._state = DeviceState(
            self._data, self._valid, self._sq_norms,
            self._high_water, len(self._id_to_slot),
            self._sweep_mirror(), *self._sweep_arrays()[1:],
            host_tables=(self._slot_ids, self._slot_meta, self._slot_values),
            prep_cache={},
        )

    # ------------------------------------------------------------------ offload

    @property
    def offloaded(self) -> bool:
        return self._offloaded is not None

    def offload(self) -> bool:
        """Move data, valid and sq_norms to host tensors and drop every device array of
        the namespace (the mirror, the residual codes and the per-row vectors are rebuilt
        from the rows on the way back).  Returns False if there is nothing to offload."""
        with self._lock:
            if self._data is None or self._offloaded is not None:
                return False
            self._offloaded = {"data": self._data.cpu(), "valid": self._valid.cpu(),
                               "sq_norms": self._sq_norms.cpu()}
            self._data = self._valid = self._sq_norms = None
            self._mirror = self._sweep_err = self._sweep_resid = None
            self._sweep_rscale = self._sweep_err1 = self._sweep_rscale2 = None
            self._state = None   # readers page the namespace in through device_state()
            return True

    def ensure_resident(self) -> bool:
        """Page an offloaded namespace back in (False when it is resident): upload the
        host copies, rebuild the sweep arrays from the rows, publish a new snapshot."""
        with self._lock:
            if self._offloaded is None:
                return False
            host = self._offloaded
            self._data = host["data"].to(self.device)
            self._valid = host["valid"].to(self.device)
            self._sq_norms = host["sq_norms"].to(self.device)
            self._build_sweep()
            self._offloaded = None
            self._publish()
            return True

    # ------------------------------------------------------------------ allocation

    def _ensure_dim(self, dim: int) -> None:
        if self.dim is None:
            self.dim = dim
            self.dpad = self.config.pad_dim(dim)
        elif dim != self.dim:
            raise ValueError(
                f"dimension mismatch in namespace {self.name!r}: store is {self.dim}-d, got {dim}-d"
            )

    def check_write(self, dims: Sequence[int], ids: Sequence[uuid_mod.UUID]) -> None:
        """Raise the error an upsert of rows of these dims and ids would raise (a
        dimension mismatch, or growth past max_capacity), changing nothing: the processor
        checks a write before it logs it."""
        with self._lock:
            dim = self.dim if self.dim is not None else (dims[0] if dims else None)
            for d in dims:
                if d != dim:
                    raise ValueError(
                        f"dimension mismatch in namespace {self.name!r}: store is "
                        f"{dim}-d, got {d}-d"
                    )
            self._check_capacity(sum(1 for vid in ids if vid not in self._id_to_slot))

    def _check_capacity(self, fresh: int) -> None:
        """Raise the MemoryError that making room for ``fresh`` new ids would raise."""
        needed = self._high_water + max(0, fresh - len(self._free))
        if needed > self.capacity and (
                self.config.round_capacity(needed) > self.config.max_capacity):
            raise MemoryError(
                f"namespace {self.name!r} would exceed max_capacity={self.config.max_capacity}"
            )

    # ------------------------------------------------------------------ sweep mirror

    def _mixed_sweep(self) -> bool:
        """f32 store + bf16 sweep mirror (JAX namespace.py:369-375)."""
        return (_storage_dtype(self.config) == torch.float32
                and self.config.sweep_dtype == "bfloat16")

    def _int8_sweep(self) -> bool:
        """int8 primary mirror (codes + dequant scales + error norms)."""
        return self.config.sweep_dtype == "int8"

    def _use_resid(self) -> bool:
        """Residual-corrected sweep (config.sweep_resid): the bf16 mirror's residual codes
        or the int8 mirror's second stream (JAX namespace.py:382-390)."""
        return self.config.sweep_resid and (self._mixed_sweep() or self._int8_sweep())

    @staticmethod
    def _mirror_ok(cap: int) -> bool:
        """The tile-major window-min output needs whole SWEEP_TILE-row tiles; smaller or
        unaligned capacities run mirror-less (the sweep path needs two tiles anyway)."""
        return cap >= SWEEP_TILE and cap % SWEEP_TILE == 0

    def _build_sweep(self) -> None:
        """(Re)build the mirror and every certificate array from the current device rows —
        whenever the mirror is rebuilt wholesale (first eligible capacity, compaction)."""
        self._mirror = self._sweep_err = None
        self._sweep_resid = self._sweep_rscale = self._sweep_err1 = None
        self._sweep_rscale2 = None
        if (self.config.sweep_dtype is None or self._rows_are_mirror()
                or self._data is None or not self._mirror_ok(self._data.shape[0])):
            return   # no mirror, or the rows' own type (_data itself)
        if self.config.sweep_dtype == "float32":
            self._mirror = self._data.float()    # a bf16 store's rows, widened
            return
        if self._int8_sweep():
            # one quantization of the whole store gives every array
            if self._use_resid():
                (self._mirror, self._sweep_rscale, self._sweep_resid, self._sweep_rscale2,
                 self._sweep_err, self._sweep_err1) = quantize_int8_resid_rows(self._data)
            else:
                self._mirror, self._sweep_rscale, self._sweep_err = quantize_int8_rows(
                    self._data)
            return
        self._mirror = self._data.to(torch.bfloat16)
        if self._use_resid():
            (self._sweep_resid, self._sweep_rscale, self._sweep_err,
             self._sweep_err1) = quantize_resid_rows(self._data)
        else:
            self._sweep_err = sweep_err_norms(self._data)

    def _alloc_arrays(self, new_cap: int) -> None:
        """Create or grow the device arrays to new_cap rows.  The row-major mirror and its
        arrays grow by appended rows like the store; a store that reaches its first
        mirror-eligible capacity builds them from its rows."""
        if self._data is None:
            self._data = torch.zeros((new_cap, self.dpad), dtype=_storage_dtype(self.config),
                                     device=self.device)
            self._valid = torch.zeros((new_cap,), dtype=torch.bool, device=self.device)
            self._sq_norms = torch.zeros((new_cap,), dtype=torch.float32, device=self.device)
            self._build_sweep()
        else:
            grow = new_cap - self.capacity
            self._data = _grow(self._data, grow)
            self._valid = _grow(self._valid, grow)
            self._sq_norms = _grow(self._sq_norms, grow)
            if self._mirror is not None:
                (self._mirror, self._sweep_err, self._sweep_resid, self._sweep_rscale,
                 self._sweep_err1, self._sweep_rscale2) = (
                    None if t is None else _grow(t, grow) for t in self._sweep_arrays())
            else:
                self._build_sweep()

    def _grow_host_tables(self, new_cap: int) -> None:
        self._slot_ids.extend([None] * (new_cap - len(self._slot_ids)))
        self._slot_meta.extend([None] * (new_cap - len(self._slot_meta)))
        self._slot_values.extend([None] * (new_cap - len(self._slot_values)))
        if self.meta_columns is not None and new_cap > self.meta_columns.capacity:
            self.meta_columns.resize(new_cap)

    def _ensure_meta_columns(self):
        """Lazily stand up the C++ columnar metadata mirror (None if no toolchain)."""
        if self.meta_columns is None and not self._meta_columns_tried:
            self._meta_columns_tried = True
            try:
                from ..native import MetaColumns, available

                if available():
                    self.meta_columns = MetaColumns(max(self.capacity, 1))
            except Exception:  # pragma: no cover - native unavailable
                self.meta_columns = None
        return self.meta_columns

    def _alloc_slot(self, vid: uuid_mod.UUID) -> int:
        """A slot for a new id (the sharded store routes it to its shard's range)."""
        if self._free:
            return self._free.pop()
        slot = self._high_water
        self._high_water += 1
        return slot

    def _free_slot(self, slot: int) -> None:
        self._free.append(slot)

    def _ensure_capacity(self, extra: int) -> None:
        new_slots = max(0, extra - len(self._free))
        needed = self._high_water + new_slots
        if needed <= self.capacity and self._data is not None:
            return
        new_cap = self.config.round_capacity(needed)
        if new_cap > self.config.max_capacity:
            raise MemoryError(
                f"namespace {self.name!r} would exceed max_capacity={self.config.max_capacity}"
            )
        self._alloc_arrays(new_cap)
        self.capacity = new_cap
        self._grow_host_tables(new_cap)

    # ------------------------------------------------------------------ mutation

    def _scatter_write(self, slots: np.ndarray, vals: np.ndarray) -> None:
        """Apply one write batch to the device arrays: one host->device copy each for
        the slots and the padded rows.  No padding of the batch width is needed: eager
        torch compiles nothing per shape."""
        slots_t = torch.from_numpy(slots).to(self.device, torch.int64)
        vals_t = torch.from_numpy(vals).to(self.device)
        self._data, self._valid, self._sq_norms = _scatter_rows(
            self._data, self._valid, self._sq_norms, slots_t, vals_t
        )
        if self._mirror is not None and self._int8_sweep():
            if self._sweep_resid is not None:
                (self._mirror, self._sweep_rscale, self._sweep_resid, self._sweep_rscale2,
                 self._sweep_err, self._sweep_err1) = _scatter_int8_resid(
                    self._mirror, self._sweep_rscale, self._sweep_resid,
                    self._sweep_rscale2, self._sweep_err, self._sweep_err1, slots_t, vals_t)
            else:
                self._mirror, self._sweep_rscale, self._sweep_err = _scatter_int8(
                    self._mirror, self._sweep_rscale, self._sweep_err, slots_t, vals_t)
        elif self._mirror is not None:
            self._mirror = _scatter_mirror(self._mirror, slots_t, vals_t)
            if self._sweep_resid is not None:
                (self._sweep_err, self._sweep_err1, self._sweep_rscale,
                 self._sweep_resid) = _scatter_resid(
                    self._sweep_err, self._sweep_err1, self._sweep_rscale,
                    self._sweep_resid, slots_t, vals_t)
            elif self._sweep_err is not None:
                self._sweep_err = _scatter_sweep_err(self._sweep_err, slots_t, vals_t)

    def upsert(self, vectors: Sequence[Vector]) -> None:
        """Insert or overwrite-by-id a batch of vectors (one device scatter)."""
        if not vectors:
            return
        with self._lock:
            if self._offloaded is not None:
                self.ensure_resident()
            self.check_write([v.dim for v in vectors], [v.id for v in vectors])
            self._ensure_dim(vectors[0].dim)
            fresh = sum(1 for v in vectors if v.id not in self._id_to_slot)
            self._ensure_capacity(fresh)

            slots = np.empty(len(vectors), np.int64)
            for i, v in enumerate(vectors):
                slot = self._id_to_slot.get(v.id)
                if slot is None:
                    slot = self._alloc_slot(v.id)
                    self._id_to_slot[v.id] = slot
                slots[i] = slot
                self._slot_ids[slot] = v.id
                self._slot_meta[slot] = v.metadata
                self._slot_values[slot] = v.values

            mc = self._ensure_meta_columns()
            if mc is not None and not mc.set_many([int(s) for s in slots],
                                                  [v.metadata for v in vectors]):
                # metadata not representable natively: drop the mirror entirely (filters
                # fall back to Python for this namespace)
                self.meta_columns = None

            vals = np.zeros((len(vectors), self.dpad), np.float32)
            for i, v in enumerate(vectors):
                vals[i, : self.dim] = v.values
            slots, vals = _last_write_wins(slots, vals)
            self._scatter_write(slots, vals)
            self.version += 1
            self._publish()

    def bulk_upsert(
        self,
        values: np.ndarray,                 # [n, dim] float32
        ids: Optional[Sequence[uuid_mod.UUID]] = None,
        metadatas: Optional[Sequence[Optional[Dict[str, Any]]]] = None,
    ) -> List[uuid_mod.UUID]:
        """Vectorized ingestion: no per-vector Python objects on the hot path —
        slots are allocated in bulk, padded once and scattered once."""
        values = np.ascontiguousarray(values, np.float32)
        n = values.shape[0]
        if n == 0:
            return []
        with self._lock:
            if self._offloaded is not None:
                self.ensure_resident()
            self._ensure_dim(int(values.shape[1]))
            if ids is None:
                ids = [uuid_mod.uuid4() for _ in range(n)]
            fresh = sum(1 for vid in ids if vid not in self._id_to_slot)
            self._ensure_capacity(fresh)

            slots = np.empty(n, np.int64)
            metas = metadatas if metadatas is not None else [None] * n
            for i, vid in enumerate(ids):
                slot = self._id_to_slot.get(vid)
                if slot is None:
                    slot = self._alloc_slot(vid)
                    self._id_to_slot[vid] = slot
                slots[i] = slot
                self._slot_ids[slot] = vid
                self._slot_meta[slot] = dict(metas[i]) if metas[i] else {}
                self._slot_values[slot] = values[i]

            mc = self._ensure_meta_columns()
            if mc is not None and not mc.set_many(
                    [int(s) for s in slots], [self._slot_meta[s] for s in slots]):
                self.meta_columns = None

            vals = np.zeros((n, self.dpad), np.float32)
            vals[:, : self.dim] = values
            slots, vals = _last_write_wins(slots, vals)
            self._scatter_write(slots, vals)
            self.version += 1
            self._publish()
            return list(ids)

    def delete(self, ids: Sequence[uuid_mod.UUID]) -> List[uuid_mod.UUID]:
        """Tombstone-delete; returns the ids actually removed."""
        with self._lock:
            if self._offloaded is not None:
                self.ensure_resident()
            slots, removed = [], []
            for vid in ids:
                slot = self._id_to_slot.pop(vid, None)
                if slot is None:
                    continue
                slots.append(slot)
                removed.append(vid)
                self._slot_ids[slot] = None
                self._slot_meta[slot] = None
                self._slot_values[slot] = None
                if self.meta_columns is not None:
                    self.meta_columns.clear(slot)
                self._free_slot(slot)
                self._tombstones += 1
            if not slots:
                return []
            self._clear_device(slots)
            self.version += 1
            self._publish()

            if self.rebuild_required():
                self.compact()
            return removed

    def _clear_device(self, slots: List[int]) -> None:
        """The device side of a delete: clear the slots' liveness."""
        slots_t = torch.as_tensor(slots, dtype=torch.int64).to(self.device)
        self._valid = _clear_slots(self._valid, slots_t)

    def rebuild_required(self) -> bool:
        """Tombstone-ratio trigger, evaluated against slots ever used."""
        if self._high_water == 0:
            return False
        return self._tombstones / self._high_water >= self.config.rebuild_threshold

    def compact(self) -> None:
        """Repack live rows to the front and shrink capacity.  Per-namespace only.  The
        squared norms are recomputed from the stored rows, as the JAX package does
        (namespace.py:786): a float64 sum cast to f32, so on a bf16 store they become
        ||bf16(row)||^2."""
        with self._lock:
            if self._offloaded is not None:
                self.ensure_resident()
            live = sorted(self._id_to_slot.items(), key=lambda kv: kv[1])
            n = len(live)
            new_ids = [vid for vid, _ in live]
            new_meta = [self._slot_meta[s] for _, s in live]
            new_vals = [self._slot_values[s] for _, s in live]
            self._id_to_slot = {vid: i for i, vid in enumerate(new_ids)}
            self._free = []
            self._high_water = n
            self._tombstones = 0
            self.version += 1

            if self.dim is None:
                return
            new_cap = self.config.round_capacity(max(n, 1))
            data = torch.zeros((new_cap, self.dpad), dtype=_storage_dtype(self.config),
                               device=self.device)
            sq_norms = torch.zeros((new_cap,), dtype=torch.float32, device=self.device)
            if self._data is not None and n:
                old = torch.as_tensor([s for _, s in live], dtype=torch.int64).to(self.device)
                data[:n] = self._data.index_select(0, old)        # gathered on the device
                sq_norms[:n] = row_sq_norms(data[:n])
            valid = torch.zeros((new_cap,), dtype=torch.bool, device=self.device)
            valid[:n] = True
            self._data, self._valid, self._sq_norms = data, valid, sq_norms
            # the certificate arrays are rebuilt in lockstep with the rows: stale bounds
            # would certify against rows that moved
            self._build_sweep()
            self.capacity = new_cap
            self._slot_ids = new_ids + [None] * (new_cap - n)
            self._slot_meta = new_meta + [None] * (new_cap - n)
            self._slot_values = new_vals + [None] * (new_cap - n)
            self._rebuild_meta_columns()
            self._publish()  # new generation visible only after everything is rebuilt

    def _rebuild_meta_columns(self) -> None:
        """Recreate the native metadata mirror after slots moved (compaction)."""
        if self.meta_columns is None:
            return
        try:
            from ..native import MetaColumns

            mc = MetaColumns(max(self.capacity, 1))
            slots = list(self._id_to_slot.values())
            for lo in range(0, len(slots), _META_CHUNK):   # one native call per chunk
                part = slots[lo : lo + _META_CHUNK]
                if not mc.set_many(part, [self._slot_meta[s] for s in part]):
                    self.meta_columns = None
                    return
            self.meta_columns = mc
        except Exception:  # pragma: no cover
            self.meta_columns = None

    # ------------------------------------------------------------------ reads

    def contains(self, vid: uuid_mod.UUID) -> bool:
        return vid in self._id_to_slot

    def get(self, vid: uuid_mod.UUID) -> Optional[Vector]:
        slot = self._id_to_slot.get(vid)
        if slot is None:
            return None
        return self._vector_at(slot, vid)

    def _vector_at(self, slot: int, vid: uuid_mod.UUID) -> Vector:
        return Vector(self._slot_values[slot], self._slot_meta[slot] or {}, id=vid)

    def slot_to_id(self, slot: int) -> Optional[uuid_mod.UUID]:
        if 0 <= slot < len(self._slot_ids):
            return self._slot_ids[slot]
        return None

    def slot_metadata(self, slot: int) -> Optional[Dict[str, Any]]:
        if 0 <= slot < len(self._slot_meta):
            return self._slot_meta[slot]
        return None

    def all_vectors(self) -> List[Vector]:
        with self._lock:
            return [self._vector_at(s, vid) for vid, s in self._id_to_slot.items()]

    def iter_slots(self) -> List[Tuple[int, uuid_mod.UUID, Optional[Dict[str, Any]]]]:
        """(slot, id, metadata) for every live row: filter compilation walks this."""
        return [(s, vid, self._slot_meta[s]) for vid, s in self._id_to_slot.items()]

    # ------------------------------------------------------------------ persistence

    def snapshot_arrays(self) -> Dict[str, Any]:
        """Host-side snapshot in the JAX package's format (live rows in slot order,
        string ids, metadata): one device->host copy of the live rows, or a read of the
        host copy while offloaded (no page-in)."""
        with self._lock:
            live = sorted(self._id_to_slot.items(), key=lambda kv: kv[1])
            src = self._data if self._offloaded is None else self._offloaded["data"]
            if src is not None and live:
                slots = torch.as_tensor([s for _, s in live], dtype=torch.int64).to(src.device)
                rows = src.index_select(0, slots)[:, : self.dim].float().cpu().numpy()
            else:
                rows = np.zeros((0, self.dim or 0), np.float32)
            return {
                "name": self.name,
                "dim": self.dim,
                "ids": [str(vid) for vid, _ in live],
                "values": rows,
                "metadata": [self._slot_meta[s] for _, s in live],
            }

    def load_snapshot(self, snap: Dict[str, Any]) -> "NamespaceStore":
        """Ingest a snapshot payload (``snapshot_arrays``' dict, or one namespace of a
        snapshot directory) into this fresh store through ``bulk_upsert``."""
        if len(snap["ids"]):
            self.bulk_upsert(
                np.asarray(snap["values"], np.float32),
                [uuid_mod.UUID(x) for x in snap["ids"]],
                snap["metadata"],
            )
        elif snap.get("dim"):
            self._ensure_dim(int(snap["dim"]))
        return self

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any], config: EngineConfig = DEFAULT_CONFIG,
                      *, device="cuda") -> "NamespaceStore":
        return cls(snap["name"], config, device=device).load_snapshot(snap)


# slots per native call when the metadata columns are rebuilt
_META_CHUNK = 1 << 16


def _last_write_wins(slots: np.ndarray, vals: np.ndarray):
    """Drop all but the last write to each slot, so the device scatter (whose order
    among duplicate indices is unspecified) lands the same rows as the host tables."""
    if len(np.unique(slots)) == len(slots):
        return slots, vals
    _, last_rev = np.unique(slots[::-1], return_index=True)
    keep = np.sort(len(slots) - 1 - last_rev)
    return slots[keep], vals[keep]
