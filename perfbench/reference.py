"""The plain reference: exact top-k in float64, and the metadata filter, over the
benchmark's own rows, metadata and queries.

Plain torch and NumPy.  It imports nothing of the program under test and takes nothing
that the program made: the rows are drawn again from the seed (``data.device_chunks``),
the filter is evaluated on the generated metadata columns.

Distances follow the engine's conventions: l2 is the squared euclidean distance, ip is
1 - <q, x>, cosine is 1 - <q, x> / (|q| |x|) (its user score is 1 - that).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

_OPS = {
    "$eq": lambda c, v: c == v,
    "$ne": lambda c, v: c != v,
    "$gt": lambda c, v: c > v,
    "$gte": lambda c, v: c >= v,
    "$lt": lambda c, v: c < v,
    "$lte": lambda c, v: c <= v,
    "$in": lambda c, v: np.isin(c, np.asarray(v)),
    "$nin": lambda c, v: ~np.isin(c, np.asarray(v)),
}


def filter_mask(columns: Dict[str, np.ndarray], spec: Optional[dict], n: int) -> np.ndarray:
    """[n] bool: the rows that ``spec`` (``{field: value}`` or ``{field: {op: value}}``,
    fields ANDed) admits.  A row without the field matches no condition on it."""
    keep = np.ones(n, bool)
    for field, cond in (spec or {}).items():
        col = columns.get(field)
        if col is None:
            return np.zeros(n, bool)
        conds = cond.items() if isinstance(cond, dict) else [("$eq", cond)]
        for op, v in conds:
            keep &= _OPS[op](col, v)
    return keep


def distance64(x: torch.Tensor, q: torch.Tensor, metric: str) -> torch.Tensor:
    """[m, n] float64 distances of queries ``q`` [m, D] to rows ``x`` [n, D]."""
    x = x.to(torch.float64)  # a no-op where the caller widened the rows once
    q = q.to(torch.float64)
    dots = q @ x.T
    if metric == "l2":
        return torch.clamp_min((q * q).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2.0 * dots, 0.0)
    if metric == "ip":
        return 1.0 - dots
    if metric == "cosine":
        qn = torch.sqrt((q * q).sum(1))[:, None]
        xn = torch.sqrt((x * x).sum(1))[None, :]
        return 1.0 - dots / torch.clamp_min(qn * xn, 1e-300)
    raise ValueError(f"unknown metric {metric!r}")


def pair_distance64(x: torch.Tensor, q: torch.Tensor, metric: str) -> torch.Tensor:
    """[m, k] float64 distances of query i ``q`` [m, D] to its own rows ``x`` [m, k, D]."""
    x = x.to(torch.float64)
    q = q.to(torch.float64)[:, None, :]
    if metric == "l2":
        return ((x - q) ** 2).sum(-1)
    dots = (x * q).sum(-1)
    if metric == "ip":
        return 1.0 - dots
    if metric == "cosine":
        return 1.0 - dots / torch.clamp_min(
            torch.sqrt((q * q).sum(-1)) * torch.sqrt((x * x).sum(-1)), 1e-300)
    raise ValueError(f"unknown metric {metric!r}")


def exact_topk(chunks: Iterable[Tuple[int, torch.Tensor]], queries: torch.Tensor, k: int,
               metric: str, keep: Optional[np.ndarray] = None,
               query_block: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """The k nearest rows of each query in float64: (rows [m, k'] int64, distances
    [m, k'] float64), ascending, k' = min(k, rows admitted).  ``chunks`` yields (first
    row, [c, D] float32 rows) on the device the reference runs on; ``keep`` [n] bool
    admits a subset of the rows (a filter)."""
    dev = queries.device
    best_d = best_i = None
    for lo, x in chunks:
        idx = torch.arange(lo, lo + x.shape[0], device=dev)
        if keep is not None:
            sel = torch.from_numpy(np.ascontiguousarray(keep[lo:lo + x.shape[0]])).to(dev)
            x, idx = x[sel], idx[sel]
            if x.shape[0] == 0:
                continue
        x = x.to(torch.float64)
        ds, ids = [], []
        for b in range(0, queries.shape[0], query_block):
            d = distance64(x, queries[b:b + query_block], metric)
            kk = min(k, d.shape[1])
            v, p = torch.topk(d, kk, dim=1, largest=False, sorted=True)
            ds.append(v)
            ids.append(idx[p])
        d, i = torch.cat(ds), torch.cat(ids)
        if best_d is not None:
            d, i = torch.cat([best_d, d], 1), torch.cat([best_i, i], 1)
        # ties in float64 go to the lower row, as a stable sort by (distance, row) gives
        order = torch.argsort(i, dim=1, stable=True)
        d, i = torch.gather(d, 1, order), torch.gather(i, 1, order)
        kk = min(k, d.shape[1])
        v, p = torch.sort(d, dim=1, stable=True)
        best_d, best_i = v[:, :kk], torch.gather(i, 1, p[:, :kk])
    if best_d is None:
        m = queries.shape[0]
        return np.zeros((m, 0), np.int64), np.zeros((m, 0), np.float64)
    return best_i.cpu().numpy(), best_d.cpu().numpy()
