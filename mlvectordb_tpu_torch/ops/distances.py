"""Pairwise distances in torch: the counterpart of ``mlvectordb_tpu/ops/distances.py``.

Internal convention: every metric is expressed as a *distance* (lower is better):
  l2     : squared euclidean  ||q||^2 + ||d||^2 - 2 q.d     (hnswlib 'l2' space convention)
  ip     : 1 - q.d                                          (hnswlib 'ip' space convention)
  cosine : 1 - q.d / (||q|| ||d||)                          (hnswlib 'cosine' convention)

The engine converts to the reference's user-facing score convention at the edge
(reference: src/mlvectordb/implementations/index.py:121-128 — raw distance for l2/ip,
1 - dist for cosine).
"""

from __future__ import annotations

import numpy as np
import torch

# Large-but-finite sentinel for masked slots, the JAX package's value: a numpy scalar so
# it compares and prints the same on both sides.
MASKED = np.float32(3.0e38)
_EPS = 1e-30


def require_f32_matmul() -> None:
    """Pin float32 matmuls to full float32, the counterpart of ``Precision.HIGHEST``.

    TF32 keeps about three decimal digits; the fused path's selection margin is a sound
    bound only when window ranking and rescan are both true f32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def query_norms(q: torch.Tensor) -> torch.Tensor:
    """Squared L2 norms of a [B, D] query block, float32 [B]."""
    qf = q.float()
    return (qf * qf).sum(-1)


def pairwise_distances(
    q: torch.Tensor,            # [B, D] queries (D lane-padded with zeros)
    db: torch.Tensor,           # [N, D] database tile
    db_sq_norms: torch.Tensor,  # [N] precomputed squared norms of db rows (float32)
    q_sq_norms: torch.Tensor,   # [B] squared norms of queries (float32)
    metric: str,
    round_query: bool = True,
) -> torch.Tensor:
    """[B, N] float32 distance block (lower is better)."""
    require_f32_matmul()
    # the query is rounded to the storage dtype first, as the JAX version does (unless
    # ``round_query`` is False); the product itself is f32 either way
    qd = q.to(db.dtype).float() if round_query else q.float()
    dots = qd @ db.float().T  # [B, N]
    if metric == "l2":
        d = q_sq_norms[:, None] + db_sq_norms[None, :] - 2.0 * dots
        return torch.clamp_min(d, 0.0)
    if metric == "ip":
        return 1.0 - dots
    if metric == "cosine":
        denom = torch.sqrt(torch.clamp_min(q_sq_norms[:, None] * db_sq_norms[None, :], _EPS))
        return 1.0 - dots / denom
    raise ValueError(f"unknown metric {metric!r}")
