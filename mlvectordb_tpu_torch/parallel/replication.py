"""ReplicationManager: replica groups over the mesh's replica axis, the counterpart of
``mlvectordb_tpu/parallel/replication.py``.

Writes are where the mechanism differs from the JAX package.  There XLA applies a write
to every replica by construction (the arrays are replicated over the replica axis).
Here each replica holds tensors of its own, so ``ShardedNamespaceStore`` fans every
write and delete out to each replica's shard tensors explicitly (its ``_scatter_write``
and ``_clear_device``).

What stays observable is verification: ``reconcile`` computes one content fingerprint
per replica group on the device, summed over its shards, and compares them.  The
fingerprint is an exact integer checksum of the stored bits (f32 or bf16 rows, dead rows
counted as zero, and the liveness mask), each element weighted by its global position,
modulo the prime 2^31 - 1: integer sums do not depend on the summation order, and a
single element that differs, by one ulp or more, always changes it.  (The JAX package
sums position-weighted rows in f32, which rounds a small difference away: ROADMAP C11.)
Fingerprints compare within one engine only; their values are not the JAX package's.
``repair`` copies the majority replica's shard tensors to every other member.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .mesh import REPLICA_AXIS, SHARD_AXIS, Mesh

_P = (1 << 31) - 1          # the checksum's prime modulus
_VALID_MULT = 1000003       # mixes the liveness sum into the data sum
_ROWS = 1 << 16             # rows per chunk of the checksum (bounded int64 temporaries)
_BITS = {torch.float32: (torch.int32, 0xFFFFFFFF), torch.bfloat16: (torch.int16, 0xFFFF)}


def _shard_checksum(data: torch.Tensor, valid: torch.Tensor, row0: int) -> int:
    """sum over elements of bits * ((pos mod (P-1)) + 1), mod P, with ``pos`` the
    element's global position (row0 + row) * Dp + col; plus the liveness bits weighted
    by row position.  Every term is reduced mod P before it is summed, so no int64
    overflows."""
    c, dp = data.shape
    itype, mask = _BITS[data.dtype]
    cols = torch.arange(dp, dtype=torch.int64, device=data.device)
    total = torch.zeros((), dtype=torch.int64, device=data.device)
    for lo in range(0, c, _ROWS):
        hi = min(c, lo + _ROWS)
        x = data[lo:hi].view(itype).to(torch.int64) & mask
        x = x * valid[lo:hi, None].to(torch.int64)
        rows = torch.arange(row0 + lo, row0 + hi, dtype=torch.int64, device=data.device)
        w = (rows[:, None] * dp + cols[None, :]) % (_P - 1) + 1
        total = (total + ((x * w) % _P).sum()) % _P
    rows = torch.arange(row0, row0 + c, dtype=torch.int64, device=data.device)
    v = (valid.to(torch.int64) * (rows % (_P - 1) + 1)).sum() % _P
    return int((total + v * _VALID_MULT) % _P)


class ReplicationManager:
    """Replica-group membership and device-side consistency verification and repair."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_replicas = mesh.shape[REPLICA_AXIS]
        self.n_shards = mesh.shape[SHARD_AXIS]

    def members(self) -> List[int]:
        return list(range(self.n_replicas))

    # ------------------------------------------------------------------ reconcile

    def fingerprints(self, data, valid) -> List[int]:
        """One checksum per replica group, summed over its shards (``data`` / ``valid``:
        ``[R][S]`` grids)."""
        out = []
        for r in range(self.n_replicas):
            fp, row0 = 0, 0
            for s in range(self.n_shards):
                fp = (fp + _shard_checksum(data[r][s], valid[r][s], row0)) % _P
                row0 += data[r][s].shape[0]
            out.append(fp)
        return out

    def reconcile(self, data, valid) -> Dict[str, Any]:
        """Compare per-replica content fingerprints; report divergence."""
        fps = self.fingerprints(data, valid)
        consistent = all(f == fps[0] for f in fps)
        return {
            "replicas": self.members(),
            "fingerprints": fps,
            "consistent": consistent,
            "divergent_replicas": [] if consistent else [
                i for i, f in enumerate(fps) if f != fps[0]
            ],
        }

    # ------------------------------------------------------------------ repair

    def _broadcast_from(self, grid, source: int):
        """Every replica's shard tensors replaced by copies of replica ``source``'s, on
        the devices (no host round trip of row data)."""
        return [grid[source] if r == source else
                [grid[source][s].to(self.mesh.devices[r][s], copy=True)
                 for s in range(self.n_shards)]
                for r in range(self.n_replicas)]

    def repair(self, data, valid, source: Optional[int] = None):
        """Reconcile and, on divergence, copy one replica's rows to every member.

        ``source``: the replica to copy from; by default the one whose fingerprint the
        majority of members share (a tie goes to the lowest replica id), as the JAX
        package and the router choose.  Returns ``(data, valid, report)``, the report
        extending reconcile()'s with ``repaired``, ``source`` and ``consistent_after``."""
        before = self.reconcile(data, valid)
        if before["consistent"]:
            return data, valid, {**before, "repaired": False, "source": None}
        if source is None:
            fps = before["fingerprints"]
            counts: Dict[Any, int] = {}
            for f in fps:
                counts[f] = counts.get(f, 0) + 1
            best = max(counts, key=lambda f: (counts[f], -fps.index(f)))
            source = fps.index(best)
        data2 = self._broadcast_from(data, source)
        valid2 = self._broadcast_from(valid, source)
        after = self.reconcile(data2, valid2)
        return data2, valid2, {
            **before,
            "repaired": True,
            "source": source,
            "consistent_after": after["consistent"],
        }
