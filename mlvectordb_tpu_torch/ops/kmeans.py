"""k-means in torch: the counterpart of ``mlvectordb_tpu/ops/kmeans.py``, the coarse
quantizer of the IVF index (store/ivf.py).

The JAX package computes it with XLA ops (``lax.scan`` over row chunks, a matmul for the
distance block, a one-hot matmul for the centroid update); no Pallas kernel is involved, so
the port computes it with torch ops, the chunk loop a Python loop over the same chunk
boundaries.

Determinism: WAL replay re-derives an index from its seed and expects the one built before
the crash, and an index built on the card must equal one built on the CPU.  So no step
sums in a varying order: the centroid update is the chunked one-hot product (not
``index_add_``, whose atomics add in launch order), ties in the nearest-centroid argmin
take the lower centroid id (``argmin`` returns the first minimum, as ``jnp.argmin``
does), and the multi-assignment takes its m nearest with a stable sort, where
``lax.top_k`` puts the lower index first among equal values.  And the distances and the
centroid sums are float64 where the JAX package's are f32: an f32 product rounds
differently on each device (and in each summation order), and a row whose two nearest
centroids lie within that rounding flips, which moves two centroids by a whole row's
share and so every later iteration (on a 2^16-row clustered corpus, one such flip per
iteration, and 464 different assignments after 10 iterations).  Training keeps float64
centroids and returns them as f32.  The initial centroids draw from
``numpy.random.default_rng(seed)`` in the JAX package's order, so they are bit-equal to
its own.
"""

from __future__ import annotations

import numpy as np
import torch


def _row_chunks(n: int, chunk: int):
    """The JAX package's chunk boundaries: ``min(chunk, n)``-row steps over the rows."""
    chunk = min(chunk, n)
    return [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]


def _cent64(centroids: torch.Tensor, rows_dtype: torch.dtype) -> torch.Tensor:
    """The centroids as the product sees them: rounded to a bf16 store's dtype first (the
    JAX package's ``centroids.astype(rows.dtype)``), then float64."""
    if rows_dtype != torch.float32:
        centroids = centroids.to(rows_dtype)
    return centroids.double()


def assign_clusters(data: torch.Tensor, valid: torch.Tensor, centroids: torch.Tensor, *,
                    chunk: int = 65536):
    """([N] int32 nearest-centroid ids (squared l2), [N] f32 distances).  Invalid rows
    get cluster -1."""
    assign, dist = _assign64(data, valid, centroids, chunk)
    return assign, dist.float()


def _assign64(data, valid, centroids, chunk):
    """assign_clusters with float64 distances."""
    N = data.shape[0]
    cent = _cent64(centroids, data.dtype)
    cn = (centroids.double() ** 2).sum(-1)
    assign = torch.empty(N, dtype=torch.int32, device=data.device)
    dist = torch.empty(N, dtype=torch.float64, device=data.device)
    for lo, hi in _row_chunks(N, chunk):
        rows = data[lo:hi].double()
        d = (rows * rows).sum(-1, keepdim=True) + cn[None, :] - 2.0 * (rows @ cent.T)
        best, a = torch.min(d, dim=1)   # the first minimum, as argmin
        assign[lo:hi] = torch.where(valid[lo:hi], a.to(torch.int32), -1)
        dist[lo:hi] = best
    return assign, dist


def assign_topm(data: torch.Tensor, valid: torch.Tensor, centroids: torch.Tensor, *, m: int,
                chunk: int = 65536) -> torch.Tensor:
    """[N, m] int32 ids of the m nearest centroids per row (squared l2), nearest first: the
    multi-assignment ("spilling") primitive of the IVF index.  Invalid rows get -1."""
    N = data.shape[0]
    cent = _cent64(centroids, data.dtype)
    cn = (centroids.double() ** 2).sum(-1)
    out = torch.empty((N, m), dtype=torch.int32, device=data.device)
    for lo, hi in _row_chunks(N, chunk):
        # the +|row|^2 term is rank-invariant per row and dropped, as in the JAX package
        d = cn[None, :] - 2.0 * (data[lo:hi].double() @ cent.T)
        if m == 1:
            top = torch.argmin(d, dim=1, keepdim=True)
        else:
            top = torch.sort(d, dim=1, stable=True).indices[:, :m]
        out[lo:hi] = torch.where(valid[lo:hi, None], top.to(torch.int32), -1)
    return out


def update_centroids(data: torch.Tensor, assign: torch.Tensor, *, n_clusters: int,
                     chunk: int = 65536):
    """One k-means update: each cluster's mean through one-hot products summed over the
    chunks in order.  Returns (centroids [C, D] f32, counts [C] f32); empty clusters keep
    zero rows."""
    centroids, counts = _update64(data, assign, n_clusters, chunk)
    return centroids.float(), counts.float()


def _update64(data, assign, n_clusters, chunk):
    """update_centroids with float64 sums and means."""
    N, D = data.shape
    ids = torch.arange(n_clusters, device=data.device)
    sums = torch.zeros((n_clusters, D), dtype=torch.float64, device=data.device)
    counts = torch.zeros(n_clusters, dtype=torch.float64, device=data.device)
    for lo, hi in _row_chunks(N, chunk):
        onehot = (assign[lo:hi, None] == ids[None, :]).double()   # [chunk, C]; -1 -> zeros
        sums = sums + onehot.T @ data[lo:hi].double()
        counts = counts + onehot.sum(0)
    return sums / torch.clamp_min(counts[:, None], 1.0), counts


def _gather_rows(data: torch.Tensor, rows: np.ndarray) -> np.ndarray:
    """f32 host copy of ``data[rows]``."""
    idx = torch.as_tensor(rows, dtype=torch.int64).to(data.device)
    return data.index_select(0, idx).float().cpu().numpy()


def _init_centroids(data: torch.Tensor, live: np.ndarray, n_clusters: int, rng,
                    max_sample: int = 20000) -> np.ndarray:
    """k-means++ (D^2 sampling) on a bounded host sample; random live rows when
    n_clusters > 1024.  The same draws from ``rng`` as the JAX package's."""
    if n_clusters > 1024:
        rows = np.sort(rng.choice(live, size=n_clusters, replace=False))
        return _gather_rows(data, rows)

    sample_idx = (
        live if len(live) <= max_sample else np.sort(rng.choice(live, max_sample, replace=False))
    )
    sample = _gather_rows(data, sample_idx)
    n = sample.shape[0]
    chosen = np.empty((n_clusters, sample.shape[1]), np.float32)
    first = rng.integers(n)
    chosen[0] = sample[first]
    d2 = ((sample - chosen[0]) ** 2).sum(-1)
    for c in range(1, n_clusters):
        total = d2.sum()
        if total <= 0:
            chosen[c] = sample[rng.integers(n)]
            continue
        pick = int(np.searchsorted(np.cumsum(d2), rng.random() * total))
        pick = min(pick, n - 1)
        chosen[c] = sample[pick]
        d2 = np.minimum(d2, ((sample - chosen[c]) ** 2).sum(-1))
    return chosen


def train_kmeans(data: torch.Tensor, valid: torch.Tensor, n_clusters: int, n_iters: int = 10,
                 seed: int = 0, chunk: int = 65536):
    """Lloyd's iterations on ``data``'s device (float64 centroids throughout).  Returns
    (centroids [C, D] f32, assign [N] int32)."""
    valid_np = valid.cpu().numpy()
    live = np.flatnonzero(valid_np)
    if len(live) < n_clusters:
        raise ValueError(f"need >= {n_clusters} live rows to train, have {len(live)}")
    rng = np.random.default_rng(seed)
    centroids = torch.from_numpy(_init_centroids(data, live, n_clusters, rng)).to(
        data.device, torch.float64)

    for _ in range(n_iters):
        assign, dist = _assign64(data, valid, centroids, chunk)
        centroids_new, counts = _update64(data, assign, n_clusters, chunk)
        empty = np.flatnonzero(counts.cpu().numpy() == 0)
        if len(empty):
            # re-seed empty clusters from the rows farthest from their centroid
            dist_np = dist.cpu().numpy().copy()
            dist_np[~valid_np] = -np.inf
            far = np.argsort(-dist_np)[: len(empty)]
            centroids_new[torch.as_tensor(empty).to(data.device)] = torch.from_numpy(
                _gather_rows(data, np.sort(far))).to(data.device, torch.float64)
        centroids = centroids_new
    assign, _ = _assign64(data, valid, centroids, chunk)
    return centroids.float(), assign
