"""Streaming exact k-NN in torch: the counterpart of ``mlvectordb_tpu/ops/topk.py``.

The database axis is tiled; each step computes one [B, tile] distance block and folds it
into a carried [B, k] result, so the full [B, N] distance matrix never exists.  The JAX
``lax.scan`` becomes a Python loop over tiles.  This is the small-namespace path (the
fused path needs at least two 4096-row tiles) and the CPU reference.
"""

from __future__ import annotations

import torch

from .distances import MASKED, pairwise_distances, query_norms


def _fold_tile(best_d, best_i, tile_d, tile_i, k):
    """Merge a [B, T] candidate block into the carried [B, k] top-k (min-distances)."""
    cand_d = torch.cat([best_d, tile_d], dim=1)
    cand_i = torch.cat([best_i, tile_i], dim=1)
    if k > 256:
        # the JAX package sorts the whole candidate block for large k (its top_k costs
        # O(W*k) on the TPU); kept so both sides select the same way
        sd, pos = torch.sort(cand_d, dim=-1, stable=True)
        return sd[:, :k], torch.gather(cand_i, 1, pos[:, :k])
    top, pos = torch.topk(cand_d, k, dim=1, largest=False)
    return top, torch.gather(cand_i, 1, pos)


def exact_knn(
    q: torch.Tensor,         # [B, D] queries, float32, lane-padded
    data: torch.Tensor,      # [cap, D] database, lane-padded
    valid: torch.Tensor,     # [cap] bool liveness mask (False = empty slot or tombstone)
    sq_norms: torch.Tensor,  # [cap] float32 squared norms of data rows
    *,
    k: int,
    metric: str,
    db_tile: int = 8192,
    round_query: bool = True,
):
    """Exact k nearest neighbours.

    Returns ``(dist [B, k] float32, idx [B, k] int32)`` sorted best-first.  Masked /
    out-of-range slots surface as ``dist >= MASKED`` with idx of some masked slot; callers
    clamp k to the live count so those never reach users.  ``round_query``: the query is
    rounded to the rows' type first, as the JAX package's scan does (False: the f32 query,
    as the certified sweep's rescan scores it).
    """
    cap = data.shape[0]
    tile = min(db_tile, cap)
    q32 = q.float()
    qn = query_norms(q32)
    B = q.shape[0]
    masked = torch.tensor(float(MASKED), dtype=torch.float32, device=q.device)

    def block(db_blk, norms_blk, valid_blk, offset):
        d = pairwise_distances(q32, db_blk, norms_blk, qn, metric, round_query)
        d = torch.where(valid_blk[None, :], d, masked)
        idx = offset + torch.arange(db_blk.shape[0], dtype=torch.int32, device=q.device)
        return d, idx[None, :].expand(B, -1)

    if cap <= tile:
        d, idx = block(data, sq_norms, valid, 0)
        kk = min(k, cap)
        best_d, pos = torch.topk(d, kk, dim=1, largest=False)
        best_i = torch.gather(idx, 1, pos)
        if kk < k:  # pad out to k with masked slots
            best_d = torch.cat([best_d, masked.expand(B, k - kk)], dim=1)
            best_i = torch.cat([best_i, best_i.new_zeros((B, k - kk))], dim=1)
        return best_d, best_i

    if cap % tile != 0:
        # odd tiling (only reachable with custom configs): pad to a tile multiple with
        # masked slots rather than materializing a one-shot [B, cap] distance matrix
        pad = tile - cap % tile
        data = torch.cat([data, data.new_zeros((pad, data.shape[1]))])
        sq_norms = torch.cat([sq_norms, sq_norms.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])  # False => masked
        cap = cap + pad

    best_d = masked.expand(B, k)
    best_i = torch.zeros((B, k), dtype=torch.int32, device=q.device)
    for lo in range(0, cap, tile):
        hi = lo + tile
        tile_d, tile_i = block(data[lo:hi], sq_norms[lo:hi], valid[lo:hi], lo)
        best_d, best_i = _fold_tile(best_d, best_i, tile_d, tile_i, k)
    return best_d, best_i


def merge_topk(dist_a, idx_a, dist_b, idx_b, *, k: int):
    """Merge two sorted-best-first top-k lists (per query row) into one."""
    return _fold_tile(dist_a, idx_a, dist_b, idx_b, k)
