"""Streaming exact k-NN in torch: the counterpart of ``mlvectordb_tpu/ops/topk.py``.

The database axis is tiled; each step computes one [B, tile] distance block and folds it
into a carried [B, k] result, so the full [B, N] distance matrix never exists.  The JAX
``lax.scan`` becomes a Python loop over tiles.  This is the small-namespace path (the
fused path needs at least two 4096-row tiles) and the CPU reference.
"""

from __future__ import annotations

import numpy as np
import torch

from .distances import MASKED, pairwise_distances, query_norms
from .settle import SPARE, f32_band, pad_k, settled_topk, value64


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
    with_key: bool = False,
    n_live: int | None = None,
):
    """Exact k nearest neighbours.

    Returns ``(dist [B, k] float32, idx [B, k] int32)`` sorted best-first, with the float64
    keys [B, k] as well under ``with_key``.  Masked / out-of-range slots surface as ``dist
    >= MASKED`` with idx of some masked slot; callers clamp k to the live count so those
    never reach users.  ``round_query``: the query is rounded to the rows' type first, as
    the JAX package's scan does (False: the f32 query, as the certified sweep's rescan
    scores it).  ``n_live``: rows from it on are the caller's zero padding, all one zero
    query: they take row ``n_live``'s float64 distances and none is flagged.

    The fold carries k + max(``settle.SPARE``, k // 2 + 16) candidates by f32 distance;
    the last step settles the first k + SPARE of them in float64 (``settle.settled_topk``,
    ROADMAP C18: the JAX package keeps the f32 order), rows tied there by slot, and
    returns fl32 of the float64 distances.  A flagged query (a host read, as the scan's
    callers read its result anyway) is settled again over the carried candidates that
    hold its band, or, where one the fold let go could still beat the k-th (its f32 value,
    at least the carried floor, minus the band of the widest live row), over every row
    within the band of the k-th (``_band_settle``).
    """
    cap = data.shape[0]
    tile = min(db_tile, cap)
    q32 = q.float()
    qn = query_norms(q32)
    B = q.shape[0]
    masked = torch.tensor(float(MASKED), dtype=torch.float32, device=q.device)
    # the query the product scores; the unrounded one where that is a rounded copy
    qd = q32.to(data.dtype).float() if round_query else q32
    q_full = q32 if round_query and data.dtype != torch.float32 else None
    qs = None if q_full is None else query_norms(qd)

    def block(db_blk, norms_blk, valid_blk, offset, qq=q32, qqn=qn):
        d = pairwise_distances(qq, db_blk, norms_blk, qqn, metric, round_query)
        d = torch.where(valid_blk[None, :], d, masked)
        idx = offset + torch.arange(db_blk.shape[0], dtype=torch.int32, device=q.device)
        return d, idx[None, :].expand(qq.shape[0], -1)

    kk = min(k, cap)
    # carried: the settle's k + SPARE, and room to settle a flagged query wider in place
    w = min(k + max(SPARE, k // 2 + 16), cap)
    if cap <= tile:
        d, idx = block(data, sq_norms, valid, 0)
        best_d, pos = torch.topk(d, w, dim=1, largest=False)
        best_i = torch.gather(idx, 1, pos)
    else:
        if cap % tile != 0:
            # odd tiling (only reachable with custom configs): pad to a tile multiple with
            # masked slots rather than materializing a one-shot [B, cap] distance matrix
            pad = tile - cap % tile
            data = torch.cat([data, data.new_zeros((pad, data.shape[1]))])
            sq_norms = torch.cat([sq_norms, sq_norms.new_zeros(pad)])
            valid = torch.cat([valid, valid.new_zeros(pad)])  # False => masked
        best_d = masked.expand(B, w)
        best_i = torch.zeros((B, w), dtype=torch.int32, device=q.device)
        for lo in range(0, data.shape[0], tile):
            hi = lo + tile
            tile_d, tile_i = block(data[lo:hi], sq_norms[lo:hi], valid[lo:hi], lo)
            best_d, best_i = _fold_tile(best_d, best_i, tile_d, tile_i, w)

    # the carried list in slot order (float64 ties go by slot), then the settle; every
    # candidate the fold let go is >= the carried floor in f32
    best_i, by_slot = torch.sort(best_i, dim=1)
    best_d = torch.gather(best_d, 1, by_slot)
    rest = None
    if w < cap:
        top = torch.where(valid, sq_norms.float(), torch.zeros_like(sq_norms.float())).amax()
        rest = (best_d.amax(1), f32_band(metric, qn, top, data.shape[1], qs))
    sqn_c = sq_norms.float()[best_i.long()]
    vals, pos, key, need = settled_topk(best_d, best_i, qd, data, qn, sqn_c, kk=kk,
                                        metric=metric, rest=rest, q_full=q_full,
                                        n_live=n_live)
    idx = torch.gather(best_i, 1, pos)
    need = need.cpu().numpy()
    for group in (np.flatnonzero((need > 0) & (need <= w)), np.flatnonzero(need > w)):
        if not len(group):
            continue
        s = torch.from_numpy(group).to(q.device)
        if need[group[0]] <= w:        # every candidate that could beat the k-th is carried
            d_w, p_w, k_w, _ = settled_topk(
                best_d[s], best_i[s], qd[s], data, qn[s], sqn_c[s], kk=kk, metric=metric,
                spare=int(need[group].max()) - kk, q_full=None if q_full is None else q32[s])
            i_w = torch.gather(best_i[s], 1, p_w)
        else:                          # one the fold let go could: over the whole band
            d_w, i_w, k_w = _band_settle(block, qd[s], q32[s], qn[s], q_full is not None,
                                         key[s, kk - 1], data, valid, sq_norms, tile=tile,
                                         kk=kk, metric=metric)
        vals, idx, key = (vals.index_copy(0, s, d_w), idx.index_copy(0, s, i_w),
                          key.index_copy(0, s, k_w))
    vals, idx, key = pad_k(vals, idx, key, k)
    return (vals, idx, key) if with_key else (vals, idx)


def _band_settle(block, qd, q32, qn, rounded, kth, data, valid, sq_norms, *, tile, kk,
                 metric):
    """The flagged queries' kk nearest in float64 order over every row whose f32 distance
    lies within its band of ``kth`` (the first settle's k-th float64 distance, at least
    the true one): no other row can beat the k-th.  Rows tied in float64 go by slot.
    ``rounded``: ``qd`` is a rounded copy of ``q32``.  One query at a time, its rows
    widened to float64 2^22 elements at a time.  (values, idx, key) [nf, kk]."""
    qs = query_norms(qd)[:, None] if rounded else None
    hits = []
    for lo in range(0, data.shape[0], tile):
        hi = lo + tile
        d, _ = block(data[lo:hi], sq_norms[lo:hi], valid[lo:hi], lo, q32, qn)
        band = f32_band(metric, qn[:, None], sq_norms[lo:hi].float()[None, :], data.shape[1], qs)
        hit = torch.nonzero(d.double() - band < kth[:, None])
        hit[:, 1] += lo
        hits.append(hit)
    hits = torch.cat(hits)                                 # (query, row), by tile then row
    step = max(1, (1 << 22) // data.shape[1])
    out = []
    for f in range(qd.shape[0]):
        rows = torch.sort(hits[hits[:, 0] == f, 1]).values
        if rounded or metric == "cosine":
            qq = (q32[f:f + 1, None, :].double() if rounded else qd[f:f + 1, None, :].double())
            qq = (qq ** 2).sum(-1)
        else:
            qq = None
        key = torch.cat([value64(qd[f:f + 1, None, :].double(), data[rows[c:c + step]][None].double(),
                                 qq, metric)[0] for c in range(0, len(rows), step)])
        top = torch.sort(key, stable=True).indices[:kk]
        key, rows = key[top], rows[top].to(torch.int32)
        if len(top) < kk:          # fewer live rows in the band than kk: masked slots
            key = torch.cat([key, key.new_full((kk - len(top),), float(MASKED))])
            rows = torch.cat([rows, rows.new_zeros(kk - len(top))])
        out.append((key, rows))
    key = torch.stack([k_ for k_, _ in out])
    return key.float(), torch.stack([r for _, r in out]), key


def merge_topk(dist_a, idx_a, dist_b, idx_b, *, k: int, key_a=None, key_b=None):
    """Merge two sorted-best-first top-k lists (per query row) into one.  With float64
    keys (``settle.settled_topk``'s), the merge orders by them, list a first on a tie,
    and returns the merged keys too (ROADMAP C18); without, by the f32 distances."""
    if key_a is None:
        return _fold_tile(dist_a, idx_a, dist_b, idx_b, k)
    cand_k = torch.cat([key_a, key_b], dim=1)
    pos = torch.sort(cand_k, dim=1, stable=True).indices[:, :k]
    return (torch.gather(torch.cat([dist_a, dist_b], dim=1), 1, pos),
            torch.gather(torch.cat([idx_a, idx_b], dim=1), 1, pos),
            torch.gather(cand_k, 1, pos))
