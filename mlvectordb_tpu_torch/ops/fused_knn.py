"""Fused exact k-NN in torch + CUDA: the counterpart of ``mlvectordb_tpu/ops/pallas_knn.py``.

Phase 1 (hand-written CUDA kernels, ``csrc/window_min.cu``): one pass over the database
computes the distance of every row to every query in f32 and writes only the min over
each window of r1 rows, a [N/r1, B] matrix; the [N, B] distance matrix never exists.
The rows are f32, or bf16 for a ``dtype="bfloat16"`` store: then the query is rounded to
bf16 as the JAX package rounds it (pallas_knn.py:333), so every product is exact and
summed in f32 (its DEFAULT precision), while ``qn`` stays the f32 query's.
Two variants, as in the JAX package:
  * fast   — no per-row input: row norms are summed in the kernel from the loaded rows,
    and rows >= the high-water mark are masked arithmetically.  Used when the namespace
    has no tombstones.
  * masked — adds a per-row bias column (l2: sq_norms + mask; ip/cosine: mask) carrying
    the tombstones.
Each kernel wrapper launches its kernel for a CUDA tensor and runs its plain torch
version (``_window_mins_*_ref``) for a CPU tensor; the CPU tests use the plain versions.

Phase 2 (torch, small tensors): two-level window selection, then an exact f32 rescan of
the candidate rows (read as f32, scored against the f32 query with the JAX package's
formulas, the l2 expansion ``qn + ||row||^2 - 2 q.row`` included) and the final top-k.

Exactness: if a true top-k element lived in a window that selection dropped, then >= s
selected windows each contain an element closer than it — contradiction with its rank
(s >= k).  The margin s = min(2k, k+16) absorbs rounding differences between the phase-1
window mins and the rescan, which holds because both are f32 (no TF32 anywhere).

Window layout: window w covers rows (w // W)*T + (w % W) + r*W for r < R1, where
W = T/R1 — the JAX package's strided layout, kept so the window-min matrices compare
element by element.  Phase 2 inverts the mapping arithmetically.

Same signature/results contract as ops.topk.exact_knn; ops.backend picks this.
"""

from __future__ import annotations

import torch

from . import _kernels
from .distances import MASKED, require_f32_matmul
from .topk import exact_knn


def _pick_r1(batch: int, n_rows: int, k: int) -> int:
    """Rows per level-1 window: the JAX package's heuristic (pallas_knn.py:59-73), kept so
    both sides select over the same windows."""
    if batch <= 32:
        return 32
    opt = (n_rows / (256.0 * (k + 16))) ** 0.5
    for r1 in (8, 16, 32):
        if opt <= r1 * 1.5:
            return r1
    return 32


# level-1 windows per level-2 window
R2 = 32
# database rows per tile of the strided window layout
DB_TILE = 4096
# query columns per tile (the fallback gate below keeps the JAX package's condition)
Q_TILE = 256

_METRIC_CODE = {"l2": 0, "ip": 1, "cosine": 2}
# rows per chunk of the plain versions' [rows, B] distance block
_REF_CHUNK_ELEMS = 1 << 25


def _window_mins_ref(data, qt, qn, *, metric, db_tile, r1, hw=None, bias=None):
    """Plain torch version of both kernels: f32 matmul per chunk of whole tiles, the same
    formula and mask, then a min over the r1 rows of each strided window."""
    require_f32_matmul()
    N = data.shape[0]
    B = qt.shape[1]
    W = db_tile // r1
    rows_per_chunk = max(db_tile, (_REF_CHUNK_ELEMS // max(B, 1)) // db_tile * db_tile)
    out = []
    for lo in range(0, N, rows_per_chunk):
        blk = data[lo : lo + rows_per_chunk].float()
        dots = blk @ qt.float()                                   # [n, B]
        sqn = (blk * blk).sum(1, keepdim=True)                    # [n, 1]
        if bias is None:
            if metric == "l2":
                dist = torch.clamp_min(sqn + qn - 2.0 * dots, 0.0)
            elif metric == "ip":
                dist = 1.0 - dots
            else:
                dist = 1.0 - dots * torch.rsqrt(torch.clamp_min(sqn * qn, 1e-30))
            row = torch.arange(lo, lo + blk.shape[0], device=data.device)[:, None]
            dist = torch.where(row < hw, dist, torch.full_like(dist, float(MASKED)))
        else:
            b = bias[lo : lo + blk.shape[0]]
            if metric == "l2":
                dist = torch.clamp_min(b + qn - 2.0 * dots, 0.0)
            elif metric == "ip":
                dist = 1.0 - dots + b
            else:
                dist = 1.0 - dots * torch.rsqrt(torch.clamp_min(sqn * qn, 1e-30)) + b
        out.append(dist.reshape(-1, r1, W, B).amin(dim=1).reshape(-1, B))
    return torch.cat(out)


def _window_mins_fast_ref(data, qt, qn, hw, *, metric, db_tile, r1):
    """Plain version of the fast kernel: rows >= hw are masked."""
    return _window_mins_ref(data, qt, qn, metric=metric, db_tile=db_tile, r1=r1, hw=hw)


def _window_mins_masked_ref(data, qt, qn, bias, *, metric, db_tile, r1):
    """Plain version of the masked kernel: a per-row bias column carries the mask."""
    return _window_mins_ref(data, qt, qn, metric=metric, db_tile=db_tile, r1=r1, bias=bias)


def _check_operands(data, qt, qn, row_input, *, metric, db_tile, r1):
    """Raise on anything the CUDA kernels do not take; returns (N, D, B)."""
    N, D = data.shape
    B = qt.shape[1]
    if data.dtype not in _kernels.ROW_TYPES:
        raise ValueError(f"data must be float32 or bfloat16; got {data.dtype}")
    tensors = {"data": data, "qt": qt, "qn": qn}
    if row_input is not None:
        tensors["bias"] = row_input
    for name, t in tensors.items():
        want = data.dtype if name == "data" else torch.float32
        if t.device != data.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {want} tensor on {data.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if qt.shape[0] != D or qn.numel() != B or (row_input is not None and row_input.numel() != N):
        raise ValueError(
            f"shape mismatch: data {tuple(data.shape)}, qt {tuple(qt.shape)}, "
            f"qn {tuple(qn.shape)}" + ("" if row_input is None else f", bias {tuple(row_input.shape)}")
        )
    if metric not in _METRIC_CODE:
        raise ValueError(f"unknown metric {metric!r}")
    if D % 8 or B % 4 or db_tile % r1 or (db_tile // r1) % 128 or N % db_tile:
        raise ValueError(
            f"kernel needs D % 8 == 0, B % 4 == 0, (db_tile / r1) % 128 == 0 and N % db_tile"
            f" == 0; got N={N} D={D} B={B} db_tile={db_tile} r1={r1}"
        )
    return N, D, B


def _window_mins_fast(data, qt, qn, hw, *, metric, db_tile, r1):
    """[N/r1, B] window mins of the fast variant (rows >= hw masked): the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if data.device.type == "cpu":
        return _window_mins_fast_ref(data, qt, qn, hw, metric=metric, db_tile=db_tile, r1=r1)
    N, D, B = _check_operands(data, qt, qn, None, metric=metric, db_tile=db_tile, r1=r1)
    out = torch.empty((N // r1, B), dtype=torch.float32, device=data.device)
    with torch.cuda.device(data.device):  # the C launch uses the runtime's current device
        rc = _kernels.library().mlvdb_window_min_fast(
            data.data_ptr(), qt.data_ptr(), qn.data_ptr(), int(hw), out.data_ptr(),
            N, D, B, db_tile, r1, _METRIC_CODE[metric], _kernels.ROW_TYPES[data.dtype],
            torch.cuda.current_stream(data.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"window_min_fast launch failed: cudaError {rc}")
    _window_mins_fast.launches += 1
    _window_mins_fast.launches_bf16 += int(data.dtype == torch.bfloat16)
    return out


def _window_mins_masked(data, qt, qn, bias, *, metric, db_tile, r1):
    """[N/r1, B] window mins of the masked variant (per-row bias column): the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if data.device.type == "cpu":
        return _window_mins_masked_ref(data, qt, qn, bias, metric=metric, db_tile=db_tile, r1=r1)
    N, D, B = _check_operands(data, qt, qn, bias, metric=metric, db_tile=db_tile, r1=r1)
    out = torch.empty((N // r1, B), dtype=torch.float32, device=data.device)
    with torch.cuda.device(data.device):
        rc = _kernels.library().mlvdb_window_min_masked(
            data.data_ptr(), qt.data_ptr(), qn.data_ptr(), bias.data_ptr(), out.data_ptr(),
            N, D, B, db_tile, r1, _METRIC_CODE[metric], _kernels.ROW_TYPES[data.dtype],
            torch.cuda.current_stream(data.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"window_min_masked launch failed: cudaError {rc}")
    _window_mins_masked.launches += 1
    _window_mins_masked.launches_bf16 += int(data.dtype == torch.bfloat16)
    return out


# kernel launches so far, and those over bf16 rows (a run resets and reads these to show
# which kernels it used)
_window_mins_fast.launches = _window_mins_fast.launches_bf16 = 0
_window_mins_masked.launches = _window_mins_masked.launches_bf16 = 0


def _select_and_rescan(q, qn_row, data, maskadd, hw, wmin1t, *, k, metric, db_tile, masked, r1):
    """Hierarchical selection over phase-1 window mins + exact rescan of candidates.

    wmin1t is [W1, B] (transposed); all wide reductions happen on small tensors.
    ``masked=False`` (fast path: live prefix [0, hw), no tombstones) masks candidates
    arithmetically against ``hw``; ``masked=True`` gathers the true per-row maskadd.
    """
    require_f32_matmul()
    B = q.shape[0]
    W1 = wmin1t.shape[0]
    dev = q.device
    # Selection margin: the exactness argument only needs s >= k (see module docstring);
    # the extra 16 absorbs float rounding differences between phase-1 window mins and the
    # f32 rescan for windows straddling the selection boundary.
    s = min(min(2 * k, k + 16), W1)

    if W1 % R2 == 0 and W1 // R2 > 1:
        W2 = W1 // R2
        wmin2 = wmin1t.reshape(W2, R2, B).amin(dim=1).T            # [B, W2]
        s2 = min(min(2 * k, k + 16), W2)
        _, w2i = torch.topk(wmin2, s2, dim=1, largest=False)       # [B, s2]
        l1_ids = (w2i[:, :, None] * R2 + torch.arange(R2, device=dev)).reshape(B, s2 * R2)
        l1_vals = torch.gather(wmin1t, 0, l1_ids.T).T              # [B, s2*R2]
    else:
        l1_ids = torch.arange(W1, device=dev)[None, :].expand(B, W1)
        l1_vals = wmin1t.T

    s1 = min(s, l1_vals.shape[1])
    _, pos = torch.topk(l1_vals, s1, dim=1, largest=False)         # [B, s1]
    win = torch.gather(l1_ids, 1, pos)                             # level-1 window ids

    # candidate rows (strided window layout, see module docstring)
    W = db_tile // r1
    base = (win // W) * db_tile + (win % W)                        # [B, s1]
    rows = (base[:, :, None] + torch.arange(r1, device=dev) * W).reshape(B, s1 * r1)

    sub = data.index_select(0, rows.reshape(-1)).float().reshape(B, s1 * r1, -1)
    dots = torch.einsum("bd,bnd->bn", q, sub)                      # [B, s1*r1], f32
    sqn_c = (sub * sub).sum(-1)                                    # norms from the rows
    if metric == "l2":
        dist = torch.clamp_min(qn_row + sqn_c - 2.0 * dots, 0.0)
    elif metric == "ip":
        dist = 1.0 - dots
    else:
        dist = 1.0 - dots * torch.rsqrt(torch.clamp_min(qn_row * sqn_c, 1e-30))
    if masked:
        dist = dist + maskadd[rows]
    else:
        dist = torch.where(rows < hw, dist, torch.full_like(dist, float(MASKED)))

    kk = min(k, dist.shape[1])
    best_d, p = torch.topk(dist, kk, dim=1, largest=False)
    best_i = torch.gather(rows, 1, p).to(torch.int32)
    if kk < k:
        best_d = torch.cat([best_d, best_d.new_full((B, k - kk), float(MASKED))], dim=1)
        best_i = torch.cat([best_i, best_i.new_zeros((B, k - kk))], dim=1)
    return best_d, best_i


def exact_knn_fused(
    q: torch.Tensor,
    data: torch.Tensor,
    valid: torch.Tensor,
    sq_norms: torch.Tensor,
    *,
    k: int,
    metric: str,
    db_tile: int = DB_TILE,
    live_prefix: int | None = None,
):
    """Drop-in fused backend for ops.topk.exact_knn (same contract).

    ``live_prefix``: host-known hint that rows [0, live_prefix) are exactly the live rows
    (no tombstones) — enables the fast no-mask kernel.  None => the masked kernel driven
    by ``valid``.

    Falls back to the tiled scan for shapes the fused path does not cover (small
    namespaces, capacities not tileable, oversized k), as the JAX version does.
    """
    cap = data.shape[0]
    B = q.shape[0]
    tile = DB_TILE
    qt_w = min(Q_TILE, B)
    r1 = _pick_r1(B, cap, k)
    if (
        cap < 2 * tile
        or cap % tile != 0
        or B % qt_w != 0
        or q.shape[1] % 128 != 0
        or k * r1 > cap
    ):
        return exact_knn(q, data, valid, sq_norms, k=k, metric=metric, db_tile=db_tile)

    q32 = q.float()
    Bk = -(-B // 4) * 4  # the kernels take query batches in multiples of 4
    qk = q32 if Bk == B else torch.cat([q32, q32.new_zeros((Bk - B, q32.shape[1]))])
    qn_k = (qk * qk).sum(-1)
    qn = qn_k.reshape(1, Bk)                                      # [1, Bk]
    # rounded to the rows' type (a no-op for f32), carried to the kernel as f32
    qtarr = qk.T.to(data.dtype).float().contiguous()              # [Dp, Bk]
    qn_row = qn_k[:B, None]                                       # [B, 1]

    if live_prefix is not None:
        wmin1t = _window_mins_fast(data, qtarr, qn, live_prefix, metric=metric, db_tile=tile, r1=r1)
        return _select_and_rescan(
            q32, qn_row, data, None, live_prefix, wmin1t[:, :B],
            k=k, metric=metric, db_tile=tile, masked=False, r1=r1,
        )

    maskadd = torch.where(valid, 0.0, float(MASKED)).to(torch.float32)   # [N]
    if metric == "l2":
        bias = (sq_norms.float() + maskadd).reshape(cap, 1)
    else:
        bias = maskadd.reshape(cap, 1)
    wmin1t = _window_mins_masked(data, qtarr, qn, bias, metric=metric, db_tile=tile, r1=r1)
    return _select_and_rescan(
        q32, qn_row, data, maskadd, cap, wmin1t[:, :B],
        k=k, metric=metric, db_tile=tile, masked=True, r1=r1,
    )
