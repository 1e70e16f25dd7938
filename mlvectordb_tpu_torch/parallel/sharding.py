"""ShardingManager: database-sharded exact search over a mesh of devices, the counterpart
of ``mlvectordb_tpu/parallel/sharding.py``.

  * Routing: the owner shard of an id is ``uuid.int % S``, bit for bit the JAX package's,
    so both packages put every id in the same shard.
  * Placement: a global ``[S*c, ...]`` tensor splits into S row blocks, one per shard,
    copied onto every replica's device of that shard (``place``).  This is what the JAX
    package's NamedShardings express.
  * Search: every shard runs the port's exact kNN on its own rows (``sharded_knn``):
    the certified sweep (kernels B1/B3 and B2) over a sweep mirror, else the masked
    row-major kernel B5, since liveness is shard-local.  Local slots become global ones
    by adding ``shard * shard_rows``, and the shards' ``[B, k]`` lists fold with
    ``merge_topk`` in shard order 0..S-1 on the replica's first device, as the JAX
    package's ``lax.scan`` over the all-gathered candidates does (span
    ``knn_sharded.merge``).

``shard_for_vector``, ``all_shards`` and ``place_database`` are the JAX package's
surface that its tests drive; the engine's write and search paths do not call them.

The query batch is data-parallel over the replica axis, as JAX's shard_map splits it:
replica r serves rows ``[r*Bb/R, (r+1)*Bb/R)`` of the padded batch.  Every shard's work
is issued before anything is read back, so on several cards the shards run at once.
"""

from __future__ import annotations

import uuid as uuid_mod
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.distances import MASKED
from ..ops.fused_knn import exact_knn_fused
from ..ops.fused_knn_t import SweepResult, exact_knn_t, fetch
from ..ops.topk import merge_topk
from ..store.namespace import DeviceState
from ..utils.tracing import trace_span
from .mesh import REPLICA_AXIS, SHARD_AXIS, Mesh

Grid = List[List[torch.Tensor]]


def _pad_k(d: torch.Tensor, i: torch.Tensor, k: int):
    """Pad a [B, kk] result to k columns with masked slots (JAX pads idx with 0)."""
    pad = k - d.shape[1]
    if pad <= 0:
        return d, i
    return (torch.cat([d, d.new_full((d.shape[0], pad), float(MASKED))], dim=1),
            torch.cat([i, i.new_zeros((i.shape[0], pad))], dim=1))


def merge_shard_results(dists: Sequence[torch.Tensor], idxs: Sequence[torch.Tensor],
                        k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold per-shard top-k lists in shard order on the first list's device."""
    bd, bi = dists[0], idxs[0]
    for d, i in zip(dists[1:], idxs[1:]):
        bd, bi = merge_topk(bd, bi, d.to(bd.device, non_blocking=True),
                            i.to(bd.device, non_blocking=True), k=k)
    return bd, bi


class ShardingManager:
    """Owns the mesh, the routing functions and the sharded search."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_replicas = mesh.shape[REPLICA_AXIS]
        self.n_shards = mesh.shape[SHARD_AXIS]

    # ------------------------------------------------------------------ routing

    def shard_for_id(self, vector_id: uuid_mod.UUID) -> int:
        """Deterministic owner shard of an id (stable across processes and packages)."""
        return vector_id.int % self.n_shards

    def shard_for_vector(self, vector) -> int:
        return self.shard_for_id(vector.id)

    def all_shards(self) -> List[int]:
        return list(range(self.n_shards))

    def device(self, replica: int, shard: int) -> torch.device:
        return self.mesh.devices[replica][shard]

    # ------------------------------------------------------------------ placement

    def place(self, x: torch.Tensor) -> Grid:
        """A global ``[S*c, ...]`` tensor (rows, or IVF clusters) as ``[R][S]`` row
        blocks, each a copy of its own on its cell's device (replicas never alias)."""
        c = x.shape[0] // self.n_shards
        if c * self.n_shards != x.shape[0]:
            raise ValueError(f"{x.shape[0]} rows do not split over {self.n_shards} shards")
        return [[x[s * c:(s + 1) * c].to(self.device(r, s), copy=True)
                 for s in range(self.n_shards)] for r in range(self.n_replicas)]

    def place_database(self, data, valid, sq_norms, mirror=None, sweep_err=None):
        """The ``[R][S]`` grid of per-shard DeviceStates over global arrays: the
        counterpart of JAX's ``place_database`` with the sweep arrays beside it (a
        ``mirror`` that is ``data`` itself stays the shard's rows)."""
        grids = [self.place(t) if t is not None else None
                 for t in (data, valid, sq_norms, None if mirror is data else mirror,
                           sweep_err)]
        c = data.shape[0] // self.n_shards
        out = []
        for r in range(self.n_replicas):
            row = []
            for s in range(self.n_shards):
                d, v, n, m, e = (None if g is None else g[r][s] for g in grids)
                row.append(DeviceState(d, v, n, c, -1, d if mirror is data else m, e,
                                       prep_cache={}))
            out.append(row)
        return out

    # ------------------------------------------------------------------ search

    def _replica_rows(self, batch: int, n_live: Optional[int]):
        """(rows per replica, [(replica, first row, live rows)]) of a padded batch split
        over the replica axis; a replica holding no live row is left out."""
        if batch % self.n_replicas:
            raise ValueError(f"batch {batch} does not split over {self.n_replicas} replicas")
        br = batch // self.n_replicas
        out = []
        for r in range(self.n_replicas):
            nq = br if n_live is None else min(max(int(n_live) - r * br, 0), br)
            if nq:
                out.append((r, r * br, nq))
        return br, out

    @staticmethod
    def _local(q, st: DeviceState, valid, prep, *, k, metric, n_live, db_tile):
        """One shard's search, issued without a host sync: the certified sweep over a
        mirror (deferred: its proof stays on the device), else the masked row-major
        kernel.  JAX's arguments: certify, the heavy program, no residual stream."""
        if st.mirror is not None:
            return exact_knn_t(q, st.mirror, st.data, valid, st.sq_norms, k=k,
                               metric=metric, live_prefix=None, sweep_err=st.sweep_err,
                               certify=True, light=False, prep_cache=prep, defer=True,
                               n_live=n_live)
        d, i = exact_knn_fused(q, st.data, valid, st.sq_norms, k=k, metric=metric,
                               db_tile=min(db_tile, st.data.shape[0]), live_prefix=None,
                               n_live=n_live)
        return SweepResult(d, i, None, -1)

    def sharded_knn(self, q: torch.Tensor, shards, *, k: int, metric: str,
                    n_live: Optional[int] = None, valid=None, prep=None,
                    db_tile: int = 8192, defer: bool = False):
        """Exact kNN over the sharded database.

        ``q`` [Bb, Dp] on the mesh's home device; ``shards`` the ``[R][S]`` grid of
        per-shard DeviceStates (``place_database``, or a sharded store's snapshot).
        ``valid`` / ``prep``: optional ``[R][S]`` grids overriding each shard's liveness
        (a filter's mask ANDed in) and its prep dict; a ``valid`` without ``prep`` gets
        a throwaway dict per shard, since prep depends on the liveness.
        ``n_live``: the batch before its zero padding; then only the live rows are
        computed and returned, and a replica holding none is skipped.
        Returns (dist [B, k], idx [B, k]) with GLOBAL slots on the home device; with
        ``defer`` a ``SweepResult`` whose ``okq`` holds every shard's per-query proofs
        (None if no shard runs a certificate) and whose ``escalate`` re-runs the failed
        shards alone and merges on the host."""
        home = self.mesh.home
        c = shards[0][0].data.shape[0]
        kk = min(k, c)
        br, replicas = self._replica_rows(q.shape[0], n_live)
        cands = {}      # replica -> [(dist, global idx) per shard] on its first device
        proofs = []     # (replica, shard, live rows, SweepResult) of certified shards
        for r, lo, nq in replicas:
            q_r = q[lo:lo + br]
            first = self.device(r, 0)
            row = []
            for s in range(self.n_shards):
                st = shards[r][s]
                dev = st.data.device
                v = st.valid if valid is None else valid[r][s]
                pc = prep[r][s] if prep is not None else (st.prep_cache if valid is None
                                                          else {})
                res = self._local(q_r.to(dev, non_blocking=True), st, v, pc, k=kk,
                                  metric=metric, n_live=None if n_live is None else nq,
                                  db_tile=db_tile)
                row.append(self._candidates(res.dist, res.idx, s, c, nq, first))
                if res.okq is not None:
                    proofs.append((r, s, nq, res))
            cands[r] = row

        def merged(lists, dev):
            """Every replica's shard lists folded in shard order, padded to k, on dev."""
            with trace_span("knn_sharded.merge", replicas=len(replicas),
                            shards=self.n_shards, k=k):
                ds, is_ = [], []
                for r, _lo, _nq in replicas:
                    bd, bi = merge_shard_results(*zip(*lists[r]), k=kk)
                    bd, bi = _pad_k(bd, bi, k)
                    ds.append(bd.to(dev, non_blocking=True))
                    is_.append(bi.to(dev, non_blocking=True))
                return torch.cat(ds), torch.cat(is_)

        dist, idx = merged(cands, home)
        okq = torch.cat([res.okq.to(home, non_blocking=True)
                         for *_, res in proofs]) if proofs else None

        def escalate(okq_host: np.ndarray, fetch_=fetch):
            """Escalate each shard whose proof failed (its own counted copies), fetch
            every other shard's tier-1 candidates in one more copy, and merge all of
            them on the host: nothing is copied back to the device."""
            tier, pos, lists = 0, 0, {r: [None] * self.n_shards for r, *_ in replicas}
            for r, s, nq, res in proofs:
                part = okq_host[pos:pos + res.okq.shape[0]]
                pos += res.okq.shape[0]
                if part.all():
                    continue
                d, i, t = res.escalate(part, fetch_)
                tier = max(tier, t)
                lists[r][s] = (torch.from_numpy(np.ascontiguousarray(d[:nq])),
                               torch.from_numpy(np.ascontiguousarray(i[:nq]) + s * c))
            rest = [(r, s) for r, row in lists.items() for s, got in enumerate(row)
                    if got is None]
            host = fetch_(*(t for r, s in rest for t in cands[r][s])) if rest else []
            for j, (r, s) in enumerate(rest):
                lists[r][s] = (torch.from_numpy(host[2 * j]),
                               torch.from_numpy(host[2 * j + 1]))
            d, i = merged(lists, torch.device("cpu"))
            return d.numpy(), i.numpy(), tier

        out = SweepResult(dist, idx, okq, -1 if okq is None else 0, escalate)
        if defer:
            return out
        d, i, _tier = out.resolve()
        return d, i

    @staticmethod
    def _candidates(d, i, shard, c, nq, device):
        """A shard's live rows with global slots, on the replica's first device."""
        return (d[:nq].to(device, non_blocking=True),
                (i[:nq] + shard * c).to(device, non_blocking=True))

    def sharded_ivf_probe(self, q, centroids, cnorms, data3: Grid, valid3: Grid,
                          sqn3: Grid, *, k: int, metric: str, nprobe: int):
        """IVF probe search over cluster-sharded inverted lists: the counterpart of
        JAX's ``sharded_ivf_probe``.

        The centroids are replicated; ``data3`` / ``valid3`` / ``sqn3`` are ``[R][S]``
        grids of ``[C/S, L, ...]`` cluster blocks.  Every query probes its GLOBAL nprobe
        nearest clusters; each shard scans the probed clusters it owns (unowned probes
        are masked, JAX's formulas) and the ``[B, k]`` lists merge in shard order.  The
        queries split over the replicas as evenly as they go (JAX's split when R
        divides B).  Returns (dist [B, k], ivf_slot [B, k]) with GLOBAL ivf slots
        (cluster * L + local) on the home device."""
        from ..store.ivf import _ivf_search

        home = self.mesh.home
        c_loc = data3[0][0].shape[0]
        br = -(-q.shape[0] // self.n_replicas)
        ds, is_ = [], []
        for r in range(self.n_replicas):
            q_r = q[r * br:(r + 1) * br]
            if not q_r.shape[0]:
                continue
            first = self.device(r, 0)
            outs = []
            for s in range(self.n_shards):
                dev = data3[r][s].device
                d, i = _ivf_search(q_r.to(dev, non_blocking=True), centroids.to(dev),
                                   cnorms.to(dev), data3[r][s], valid3[r][s], sqn3[r][s],
                                   k=k, metric=metric, nprobe=nprobe, c_off=s * c_loc)
                outs.append((d.to(first, non_blocking=True), i.to(first, non_blocking=True)))
            bd, bi = merge_shard_results(*zip(*outs), k=k)
            ds.append(bd.to(home, non_blocking=True))
            is_.append(bi.to(home, non_blocking=True))
        return torch.cat(ds), torch.cat(is_)
