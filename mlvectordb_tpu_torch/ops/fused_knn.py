"""Fused exact k-NN in torch + CUDA: the counterpart of ``mlvectordb_tpu/ops/pallas_knn.py``.

Phase 1 (hand-written CUDA kernels, ``csrc/window_min.cu``): one pass over the database
computes the distance of every row to every query and writes only the min over each
window of r1 rows, a [N/r1, B] matrix; the [N, B] distance matrix never exists.  The
products run on the tensor cores, as the JAX kernels' run on the MXU (pallas_knn.py:93-99):
bf16 rows (a ``dtype="bfloat16"`` store) in one bf16 pass against the query rounded to
bf16 as the JAX package rounds it (pallas_knn.py:333), f32 sums, while ``qn`` stays the
f32 query's; f32 rows as six bf16 passes of a three-way split (hi + mid + lo, the TPU's
multi-pass HIGHEST product), whose dots stay within Dp * 2^-23 * |q||x| of the exact ones
(``_phase1_budget``; the kernel's note gives the argument).
Two variants, as in the JAX package:
  * fast   — no per-row input: row norms are summed in the kernel from the loaded rows,
    and rows >= the high-water mark are masked arithmetically.  Used when the namespace
    has no tombstones.
  * masked — adds a per-row bias column (l2: sq_norms + mask; ip/cosine: mask) carrying
    the tombstones.
Each kernel wrapper launches its kernel for a CUDA tensor and runs its plain torch
version (``_window_mins_*_ref``, f32) for a CPU tensor; the CPU tests use the plain versions.
``n_live``: the caller's queries from ``n_live`` on are padding; the wrappers compute only
the first ``n_live`` columns (rounded up to the tensor-core product's n of 8), and
``exact_knn_fused`` selects and rescans the live rows alone.

Phase 2 (torch, small tensors): two-level window selection, then an exact f32 rescan of
the candidate rows (read as f32, scored against the f32 query with the JAX package's
formulas, the l2 expansion ``qn + ||row||^2 - 2 q.row`` included) and the final top-k.

Exactness: if a true top-k element lived in a window that selection dropped, then >= s
selected windows each contain an element closer than it — contradiction with its rank
(s >= k).  The margin s = min(2k, k+16) absorbs rounding differences between the phase-1
window mins and the f32 rescan: both are f32-level (phase 1 within Dp * 2^-23 of |q||x|,
as the TPU's HIGHEST product; TF32 alone, at 2^-11, would not be).

Window layout: window w covers rows (w // W)*T + (w % W) + r*W for r < R1, where
W = T/R1 — the JAX package's strided layout, kept so the window-min matrices compare
element by element.  Phase 2 inverts the mapping arithmetically.

Same signature/results contract as ops.topk.exact_knn; ops.backend picks this.
"""

from __future__ import annotations

import torch

from . import _kernels
from .distances import MASKED, require_f32_matmul
from .fused_knn_t import SweepResult, _live_columns
from .settle import Settled
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


def _split3(x: torch.Tensor):
    """f32 ``x`` as three bf16 parts (hi, mid, lo) with hi + mid + lo == x, as the
    tensor-core kernels split each f32 element: hi = bf16_rn(x), mid = bf16_rn(x - hi),
    lo = bf16(x - hi - mid); the remainders are exact in f32.  Exact for |x| from 2^-110
    to bf16's largest finite value, and 0."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def _query_parts(rows: torch.Tensor, n_c: int, *, split: bool) -> torch.Tensor:
    """Kernel B4/B5's bf16 query operand from the first ``n_c`` of ``rows`` [B, D]:
    [P, Bq, D], Bq = n_c rounded up to 8, zero past n_c.  ``split``: P = 3, the f32 rows'
    hi, mid and lo parts (``_split3``; f32 rows); else P = 1, the values rounded to bf16."""
    bq = -(-n_c // 8) * 8
    parts = _split3(rows[:n_c]) if split else (rows[:n_c].to(torch.bfloat16),)
    q = torch.zeros((len(parts), bq, rows.shape[1]), dtype=torch.bfloat16, device=rows.device)
    for p, part in enumerate(parts):
        q[p, :n_c] = part
    return q


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


def _phase1_budget(data, qt, qn, *, metric, db_tile, r1, hw=None, bias=None):
    """Per-element bound on |kernel - plain| of B4/B5's window mins, shaped as they are
    ([N/r1, B] for qt [D, B]; ``hw`` for the fast variant, ``bias`` for the masked one).

    Each dot is within Dp * 2^-23 * |q||x| of the exact one on the tensor cores (the bar
    ``chip_smoke.py`` measures, for the bf16 pass and the f32 split alike) and within
    Dp * 2^-24 * |q||x| in the plain version's f32 sums; each side's f32 row norm within
    Dp * 2^-24 * |x|^2; the epilogue's roundings (rsqrt's approximation included) within
    2^-21 of each term's magnitude.  A window min moves by at most the largest of its live
    rows' bounds (min is 1-Lipschitz); dead rows (>= hw, or a bias >= MASKED / 2) never
    hold a live window's min, and a window of dead rows is MASKED on both sides."""
    N, Dp = data.shape
    W = db_tile // r1
    tc, eps = Dp * (2.0 ** -23 + 2.0 ** -24), 2.0 ** -21
    dev = data.device
    x = torch.cat([torch.linalg.vector_norm(data[i:i + (1 << 20)].float(), dim=1)
                   for i in range(0, N, 1 << 20)])                        # |x| [N]
    rows = torch.arange(N, device=dev)
    live = rows < hw if bias is None else bias.reshape(-1) < MASKED / 2

    def wmax(v):    # [N] -> the largest over each window's live rows, [N/r1, 1]
        v = torch.where(live, v, torch.zeros_like(v))
        return v.reshape(-1, r1, W).amax(1).reshape(-1, 1)

    q = torch.linalg.vector_norm(qt.float(), dim=0)[None, :]             # |q| [1, B]
    qn = qn.reshape(1, -1).float()
    if metric == "cosine":
        # |dot| * rsqrt(|x|^2 |q_f32|^2) <= |q| / |q_f32|; the rsqrt and the norms
        # relative errors scale it
        ratio = torch.where(qn > 0, q / qn.clamp_min(1e-30).sqrt(), torch.zeros_like(q))
        col = ratio * (tc + Dp * 2.0 ** -24 + 6 * 2.0 ** -22) + 2 * eps
        return torch.where(wmax(torch.ones_like(x)) > 0, col, torch.zeros_like(col))
    if metric == "ip":
        return q * (tc + eps) * wmax(x) + eps
    s = x * x if bias is None else bias.reshape(-1).abs()
    out = 2 * q * (tc + eps) * wmax(x) + eps * (wmax(s) + qn)
    if bias is None:
        out = out + 2 * Dp * 2.0 ** -24 * wmax(x * x)
    return out


def _check_operands(data, qt, qn, row_input, *, metric, db_tile, r1):
    """Raise on anything the CUDA kernel does not take; returns (N, D, B)."""
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
    if D % 128 or B % 4 or db_tile % r1 or (db_tile // r1) % 128 or N % db_tile:
        raise ValueError(
            f"kernel needs D % 128 == 0, B % 4 == 0, (db_tile / r1) % 128 == 0 and "
            f"N % db_tile == 0; got N={N} D={D} B={B} db_tile={db_tile} r1={r1}"
        )
    return N, D, B


def _kernel_queries(qt, qn, n_c, dtype):
    """The kernel's query operands for the first ``n_c`` columns of qt [D, B] and qn
    [1, B]: bf16 parts [P, Bq, D] (f32 rows: the split hi, mid, lo; bf16 rows: the values,
    which the caller has rounded to bf16) and qn [Bq], Bq = n_c rounded up to 8, zero past
    n_c."""
    q = _query_parts(qt.T, n_c, split=dtype == torch.float32)
    bq = q.shape[1]
    qn_k = torch.zeros(bq, dtype=torch.float32, device=qt.device)
    qn_k[:n_c] = qn.reshape(-1)[:n_c]
    return q, qn_k, bq


def _launch(fn, data, qt, qn, hw, bias, *, metric, db_tile, r1, n_live):
    """Launch kernel B4 (``bias`` None) or B5 on the first ``_live_columns(B, n_live)``
    query columns, counted on the wrapper ``fn``; returns [N/r1, n_c]."""
    N, D, B = _check_operands(data, qt, qn, bias, metric=metric, db_tile=db_tile, r1=r1)
    n_c = _live_columns(B, n_live)
    q, qn_k, bq = _kernel_queries(qt, qn, n_c, data.dtype)
    out = torch.empty((N // r1, n_c), dtype=torch.float32, device=data.device)
    with torch.cuda.device(data.device):  # the C launch uses the runtime's current device
        rc = _kernels.library().mlvdb_window_min(
            data.data_ptr(), q.data_ptr(), qn_k.data_ptr(),
            None if bias is None else bias.data_ptr(), int(hw), out.data_ptr(), N, D, n_c, bq,
            db_tile, r1, _METRIC_CODE[metric], _kernels.ROW_TYPES[data.dtype],
            torch.cuda.current_stream(data.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"window_min launch failed: cudaError {rc}")
    fn.launches += 1
    fn.launches_bf16 += int(data.dtype == torch.bfloat16)
    fn.cols += n_c
    return out


def _window_mins_fast(data, qt, qn, hw, *, metric, db_tile, r1, n_live=None):
    """[N/r1, n_c] window mins of the fast variant (rows >= hw masked) for the first
    n_c = ``_live_columns(B, n_live)`` queries of qt [D, B]: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor.  For bf16 rows qt holds bf16 values."""
    if data.device.type == "cpu":
        n_c = _live_columns(qt.shape[1], n_live)
        return _window_mins_fast_ref(data, qt[:, :n_c], qn[:, :n_c], hw, metric=metric,
                                     db_tile=db_tile, r1=r1)
    return _launch(_window_mins_fast, data, qt, qn, hw, None, metric=metric, db_tile=db_tile,
                   r1=r1, n_live=n_live)


def _window_mins_masked(data, qt, qn, bias, *, metric, db_tile, r1, n_live=None):
    """[N/r1, n_c] window mins of the masked variant (per-row bias column) for the first
    n_c = ``_live_columns(B, n_live)`` queries of qt [D, B]: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor.  For bf16 rows qt holds bf16 values."""
    if data.device.type == "cpu":
        n_c = _live_columns(qt.shape[1], n_live)
        return _window_mins_masked_ref(data, qt[:, :n_c], qn[:, :n_c], bias, metric=metric,
                                       db_tile=db_tile, r1=r1)
    return _launch(_window_mins_masked, data, qt, qn, 0, bias, metric=metric, db_tile=db_tile,
                   r1=r1, n_live=n_live)


# kernel launches so far, those over bf16 rows, and the query columns they computed (a run
# resets and reads these to show which kernels it used)
for _fn in (_window_mins_fast, _window_mins_masked):
    _fn.launches = _fn.launches_bf16 = _fn.cols = 0
del _fn


def _select_and_rescan(q, qn_row, data, maskadd, hw, wmin1t, *, k, metric, db_tile, masked, r1):
    """Hierarchical selection over phase-1 window mins + exact rescan of candidates, whose
    top-k is settled in float64 (``settle.Settled``, ROADMAP C18).

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

    return Settled(dist, rows.to(torch.int32), q, data, qn_row, sqn_c,
                   kk=min(k, dist.shape[1]), k=k, metric=metric)


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
    n_live: int | None = None,
    defer: bool = False,
):
    """Drop-in fused backend for ops.topk.exact_knn (same contract).

    ``live_prefix``: host-known hint that rows [0, live_prefix) are exactly the live rows
    (no tombstones) — enables the fast no-mask kernel.  None => the masked kernel driven
    by ``valid``.

    ``n_live``: the caller's batch before it padded ``q`` with zero rows (None: every row
    is live).  Phase 1 computes the live query columns alone (rounded up to 8), selection
    and rescan run on the live rows alone, and the result has ``n_live`` rows.  r1 and the
    gate below read the padded batch, as the JAX package's do.

    Falls back to the tiled scan for shapes the fused path does not cover (small
    namespaces, capacities not tileable, oversized k), as the JAX version does.

    ``defer``: return a ``fused_knn_t.SweepResult`` (tier -1, no proof) whose ``need``
    flags the queries the rescan's float64 settle must settle again wider (ROADMAP C18),
    so the caller brings them down in its one copy; else those are settled here.
    """
    cap = data.shape[0]
    B = q.shape[0]
    nq = B if n_live is None else min(B, max(int(n_live), 1))   # the live rows
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
        d, i, key = exact_knn(q[:nq], data, valid, sq_norms, k=k, metric=metric,
                              db_tile=db_tile, with_key=True)
        return SweepResult(d, i, None, -1, key=key) if defer else (d, i)

    q32 = q.float()
    Bk = -(-B // 4) * 4  # the kernels take query batches in multiples of 4
    qk = q32 if Bk == B else torch.cat([q32, q32.new_zeros((Bk - B, q32.shape[1]))])
    qn_k = (qk * qk).sum(-1)
    qn = qn_k.reshape(1, Bk)                                      # [1, Bk]
    # rounded to the rows' type (a no-op for f32), carried to the kernel as f32
    qtarr = qk.T.to(data.dtype).float().contiguous()              # [Dp, Bk]
    qn_row = qn_k[:nq, None]                                      # [nq, 1]
    kw = dict(metric=metric, db_tile=tile, r1=r1, n_live=None if n_live is None else nq)

    if live_prefix is not None:
        wmin1t = _window_mins_fast(data, qtarr, qn, live_prefix, **kw)
        st = _select_and_rescan(
            q32[:nq], qn_row, data, None, live_prefix, wmin1t[:, :nq],
            k=k, metric=metric, db_tile=tile, masked=False, r1=r1,
        )
    else:
        maskadd = torch.where(valid, 0.0, float(MASKED)).to(torch.float32)   # [N]
        if metric == "l2":
            bias = (sq_norms.float() + maskadd).reshape(cap, 1)
        else:
            bias = maskadd.reshape(cap, 1)
        wmin1t = _window_mins_masked(data, qtarr, qn, bias, **kw)
        st = _select_and_rescan(
            q32[:nq], qn_row, data, maskadd, cap, wmin1t[:, :nq],
            k=k, metric=metric, db_tile=tile, masked=True, r1=r1,
        )
    if defer:
        return SweepResult(st.dist, st.idx, None, -1, settled=st)
    d, i, _ = st.resolve()
    return d, i
