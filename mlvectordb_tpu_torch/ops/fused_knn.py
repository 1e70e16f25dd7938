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

Phase 2 (torch, small tensors): two-level window selection of s = min(2k, k+16) windows
(the JAX package's width), then an exact f32 rescan of the candidate rows (read as f32,
scored against the f32 query with the JAX package's formulas, the l2 expansion
``qn + ||row||^2 - 2 q.row`` included), the top k settled in float64 (``settle.Settled``,
ROADMAP C18), and a per-query proof (ROADMAP C20; the JAX package proves nothing here).

Proof.  Let p(x) be phase 1's f32 value of row x and d(x) its exact distance.  Every row
of a window that was not rescanned has p(x) >= thresh, the smallest phase-1 window min
among those windows (the (s2+1)-th of the level-2 mins and the (s1+1)-th of the selected
level-2 windows' level-1 mins; a min >= MASKED/2 holds no live row and is left out).  If
|p(x) - d(x)| <= err for every live row that could beat the k-th, and thresh - err >
kth + u |kth| (kth: the settled k-th distance, fl32 of its float64 value, so within half
an ulp, u = 2^-24, of it), no row outside the rescan can beat the k-th, and the rescan's
float64 top k is the set and order of the float64 oracle.  The comparison runs in
float64.  ``_Proof`` gives err per query, with maxd >= the largest live row norm (from
``sq_norms``, kept per snapshot; at l2 the smaller of that and |q| + sqrt(d_k), since a
row of larger norm lies outside the k-th's ball: d(x) >= (|x| - |q|)^2 > d_k), |q|, qn
the f32 |q|^2, dq = |q - q'| where phase 1 scores the query q' (a bf16 store's rounds it
to bf16; 0 for f32 rows), qa = |q| + dq, c = Dp 2^-23 (a dot on the tensor cores, the
bf16 pass or the f32 split, and the plain version's f32 sums), g = (Dp + 4) u /
(1 - (Dp + 4) u) (each norm's f32 sum) and e = 2^-21 (the epilogue's roundings, rsqrt's
within it):

  l2      2 c qa maxd + 2 dq maxd + g (maxd^2 + qn) + e (maxd^2 + qn + 2 qa maxd)
  ip      c qa maxd + dq maxd + e (1 + qa maxd)
  cosine  ((2 c + 2 g + 6 2^-22) qa + dq) / |q| + 2 e        (2 e where q = 0)

each term the bound of one difference between p(x) and d(x): the dot (and the rounded
query's share of it), the row norm (in the kernel, or the store's ``sq_norms`` in B5's
bias, either within g of |x|^2), qn's f32 sum, and the epilogue's adds; cosine's are
relative to |q||x|.  The whole is widened by 2^-20 for its own arithmetic.  A query
whose proof fails escalates as the certified sweep does (``fused_knn_t._ladder``): the
failing queries are selected again at 8x the width and proved again (contained when at
most 8 fail), then the exact scan over the f32 query.  ``certify=False`` is the JAX
package's margin mode: no proof, the s-window selection returned as it is.

Window layout: window w covers rows (w // W)*T + (w % W) + r*W for r < R1, where
W = T/R1 — the JAX package's strided layout, kept so the window-min matrices compare
element by element.  Phase 2 inverts the mapping arithmetically.

Same signature/results contract as ops.topk.exact_knn; ops.backend picks this.
"""

from __future__ import annotations

import torch

from . import _kernels
from .distances import MASKED, require_f32_matmul
from .fused_knn_t import FQ_CONTAIN, SweepResult, _ladder, _live_columns
from .settle import U, Settled
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


def _smallest(x, s: int):
    """(positions of the s smallest of each row of x [B, W], the (s+1)-th smallest value
    [B], None where s covers the row): one top-k one element wider than the selection."""
    n = min(s + 1, x.shape[1])
    vals, pos = torch.topk(x, n, dim=1, largest=False)
    return (pos, None) if n == s else (pos[:, :s], vals[:, s])


def _select_and_rescan(q, qn_row, data, maskadd, hw, wmin1t, *, k, metric, db_tile, masked, r1,
                       s_sel=None):
    """Hierarchical selection of ``s_sel`` windows (default the JAX package's
    min(2k, k+16)) over phase-1 window mins + exact rescan of candidates, whose top-k is
    settled in float64 (``settle.Settled``, ROADMAP C18).  Returns ``(settled, thresh)``:
    every live row of a window not rescanned has a phase-1 value >= thresh [B] (+inf
    where no such window holds a live row).

    wmin1t is [W1, B] (transposed); all wide reductions happen on small tensors.
    ``masked=False`` (fast path: live prefix [0, hw), no tombstones) masks candidates
    arithmetically against ``hw``; ``masked=True`` gathers the true per-row maskadd.
    """
    require_f32_matmul()
    B = q.shape[0]
    W1 = wmin1t.shape[0]
    dev = q.device
    s = min(s_sel or min(2 * k, k + 16), W1)

    if W1 % R2 == 0 and W1 // R2 > 1:
        W2 = W1 // R2
        wmin2 = wmin1t.reshape(W2, R2, B).amin(dim=1).T            # [B, W2]
        w2i, th2 = _smallest(wmin2, min(s, W2))                     # [B, s2]
        l1_ids = (w2i[:, :, None] * R2 + torch.arange(R2, device=dev)).reshape(B, -1)
        l1_vals = torch.gather(wmin1t, 0, l1_ids.T).T              # [B, s2*R2]
    else:
        l1_ids = torch.arange(W1, device=dev)[None, :].expand(B, W1)
        l1_vals = wmin1t.T
        th2 = None

    s1 = min(s, l1_vals.shape[1])
    pos, th1 = _smallest(l1_vals, s1)                              # [B, s1]
    win = torch.gather(l1_ids, 1, pos)                             # level-1 window ids
    # the smallest phase-1 min left out: the (s2+1)-th level-2 min or the (s1+1)-th of
    # the selected blocks' level-1 mins; +inf where none is left out or it is a masked
    # window's (>= MASKED/2: no window past it holds a live row); NaN stays NaN
    th = [t for t in (th1, th2) if t is not None]
    if not th:
        thresh = torch.full((B,), float("inf"), device=dev)
    else:
        thresh = th[0] if len(th) == 1 else torch.minimum(*th)
        thresh = torch.where(thresh >= float(MASKED) / 2, float("inf"), thresh)

    # candidate rows (strided window layout, see module docstring), in row order: the
    # settle breaks float64 ties by position, so by row, as the scan and the oracle do
    W = db_tile // r1
    base = (win // W) * db_tile + (win % W)                        # [B, s1]
    rows = (base[:, :, None] + torch.arange(r1, device=dev) * W).reshape(B, s1 * r1)
    rows = torch.sort(rows, dim=1).values

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
                   kk=min(k, dist.shape[1]), k=k, metric=metric), thresh


def _row_maxd(sq_norms, live, dp: int):
    """maxd, a 0-dim float64 tensor >= the largest norm of the ``live`` rows: their largest
    ``sq_norms`` (an f32 sum within g of |x|^2) widened by 2g."""
    g = (dp + 4) * U / (1 - (dp + 4) * U)
    top = torch.where(live, sq_norms.float(), torch.zeros_like(sq_norms.float())).amax()
    return torch.sqrt(top.double() * (1 + 2 * g))


class _Proof:
    """The per-query proof of one batch (module docstring): ``err(kth)`` the table's bound
    [B] float64 and ``proven(kth, thresh)`` the test, for the settled k-th ``kth`` [B] and
    the smallest phase-1 min left out ``thresh`` [B]; ``rows`` takes the queries a
    re-selection proves.  ``maxd``: ``_row_maxd``'s (None for cosine); ``qn`` [B] the f32
    query norms phase 1 adds; ``dq`` [B] |q - q'| of the query q' it scores (None: q' = q).
    The query's terms are computed once.  At l2 only a row within the k-th's ball can beat
    it, and such a row's norm is at most |q| + sqrt(d_k): the table's maxd is the smaller
    of the two there."""

    def __init__(self, metric: str, maxd, qn, dq, dp: int):
        c, e, w = dp * 2.0 ** -23, 2.0 ** -21, 1 + 2.0 ** -20
        g = (dp + 4) * U / (1 - (dp + 4) * U)
        self.metric, self.maxd, self.alpha = metric, maxd, (g + e) * w
        qn = qn.double()
        s = qn.sqrt()
        dq = None if dq is None else dq.double()
        self.q_up = self.ks = None
        if metric == "cosine":
            a = 2 * c + 2 * g + 6 * 2.0 ** -22
            # the constant is widened by 2^-20, more than its rounding to f32 here
            self.fixed = torch.where(qn > 0, (a * (1 + g) / (1 - g) + 2 * e) * w,
                                     2 * e * w).double()
            if dq is not None:
                self.fixed = self.fixed + torch.where(qn > 0, dq / s, 0.0) * (
                    (a + 1) / (1 - g) * w)
        elif metric == "ip":
            self.fixed = maxd * s * ((c + e) * (1 + g) * w) + e * w
            if dq is not None:
                self.fixed = self.fixed + maxd * dq * ((c + e + 1) * w)
        else:   # err = (ks + (g + e) m) m + (g + e) qn, m = min(maxd, |q| + sqrt(d_k))
            self.q_up = s * (1 + g)
            self.ks = s * ((2 * c + 2 * e) * (1 + g) * w)
            if dq is not None:
                self.ks = self.ks + dq * ((2 * c + 2 * e + 2) * w)
            self.fixed = qn * ((g + e) * w)

    def rows(self, sub):
        """The proof of the queries ``sub`` alone."""
        out = object.__new__(_Proof)
        out.metric, out.maxd, out.alpha = self.metric, self.maxd, self.alpha
        out.fixed = self.fixed[sub]
        out.q_up, out.ks = ((None, None) if self.q_up is None
                            else (self.q_up[sub], self.ks[sub]))
        return out

    def err(self, kth):
        """[B] float64 err for the settled k-th ``kth`` (float64 or f32, >= 0 at l2)."""
        if self.metric != "l2":
            return self.fixed
        m = torch.minimum(self.maxd, torch.add(self.q_up, kth.double().sqrt(), alpha=1 + U))
        return torch.addcmul(self.fixed, torch.add(self.ks, m, alpha=self.alpha), m)

    def proven(self, kth, thresh):
        """[B] bool: thresh - err > kth + u |kth| (kth: fl32 of its float64 distance), in
        float64.  A k-th that is a masked slot (fewer live candidates than k) passes only
        where thresh is +inf (no window left out holds a live row); a NaN fails."""
        k64 = kth.double()
        if self.metric == "ip":     # the one metric whose distances go below 0
            up = torch.add(torch.add(k64, k64.abs(), alpha=U), self.err(k64))
        else:
            up = torch.add(self.err(k64), k64, alpha=1 + U)
        return thresh.double() > up


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
    certify: bool = True,
    prep_cache: dict | None = None,
    report_tier: bool = False,
    defer: bool = False,
):
    """Drop-in fused backend for ops.topk.exact_knn (same contract).

    ``live_prefix``: host-known hint that rows [0, live_prefix) are exactly the live rows
    (no tombstones) — enables the fast no-mask kernel.  None => the masked kernel driven
    by ``valid``.

    ``n_live``: the caller's batch before it padded ``q`` with zero rows (None: every row
    is live).  Phase 1 computes the live query columns alone (rounded up to 8), selection,
    rescan and proof run on the live rows alone, and the result has ``n_live`` rows.  r1,
    the gate below and the escalation's gates read the padded batch, as the JAX
    package's and the certified sweep's do.

    Falls back to the tiled scan for shapes the fused path does not cover (small
    namespaces, capacities not tileable, oversized k), as the JAX version does.

    ``certify``: prove each query's set and escalate where the proof fails (ROADMAP C20,
    module docstring); False is the JAX package's margin mode.  ``prep_cache``: the
    snapshot's prep dict, where the proof's row-norm bound is kept.  ``report_tier`` adds
    the tier that served the batch: 0 the s-window selection proven, 1 the contained or
    widened selection, 2 the exact scan, -1 no proof ran (margin mode, or the gate sent
    the search to the scan).  ``defer``: return the device-side ``fused_knn_t.SweepResult``
    (its proof and the float64 settle's flags, ROADMAP C18, for the caller's one copy).
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
        res = SweepResult(d, i, None, -1, key=key)
    else:
        res = _fused(q, data, valid, sq_norms, k=k, metric=metric, r1=r1, nq=nq,
                     live_prefix=live_prefix, certify=certify, prep_cache=prep_cache,
                     n_live=n_live)
    if defer:
        return res
    d, i, tier = res.resolve()
    return (d, i, tier) if report_tier else (d, i)


def _fused(q, data, valid, sq_norms, *, k, metric, r1, nq, live_prefix, certify, prep_cache,
           n_live):
    """Phase 1, the s-window selection and rescan, and the proof with its escalation
    packed into a ``SweepResult`` (``exact_knn_fused``'s shapes)."""
    cap, dp = data.shape
    B = q.shape[0]
    tile = DB_TILE
    q32 = q.float()
    Bk = -(-B // 4) * 4  # the kernels take query batches in multiples of 4
    qk = q32 if Bk == B else torch.cat([q32, q32.new_zeros((Bk - B, q32.shape[1]))])
    qn_k = (qk * qk).sum(-1)
    qn = qn_k.reshape(1, Bk)                                      # [1, Bk]
    # rounded to the rows' type (a no-op for f32), carried to the kernel as f32
    qtarr = qk.T.to(data.dtype).float().contiguous()              # [Dp, Bk]
    qn_row = qn_k[:nq, None]                                      # [nq, 1]
    kw = dict(metric=metric, db_tile=tile, r1=r1, n_live=None if n_live is None else nq)

    masked = live_prefix is None
    # the live rows: the fast kernel masks rows >= hw and reads no ``valid``
    live = valid if masked else torch.arange(cap, device=data.device) < live_prefix
    if masked:
        hw = cap
        maskadd = torch.where(valid, 0.0, float(MASKED)).to(torch.float32)   # [N]
        bias = (sq_norms.float() + maskadd) if metric == "l2" else maskadd
        wmin1t = _window_mins_masked(data, qtarr, qn, bias.reshape(cap, 1), **kw)
    else:
        hw, maskadd = live_prefix, None
        wmin1t = _window_mins_fast(data, qtarr, qn, live_prefix, **kw)
    wmin1t = wmin1t[:, :nq]
    q_live = q32[:nq]

    def select(s_sel=None, sub=None):
        """(Settled, thresh) of the s_sel-window selection for the live rows, or the
        rows ``sub`` of them."""
        sub = slice(None) if sub is None else sub
        return _select_and_rescan(q_live[sub], qn_row[sub], data, maskadd, hw, wmin1t[:, sub],
                                  k=k, metric=metric, db_tile=tile, masked=masked, r1=r1,
                                  s_sel=s_sel)

    st1, th1 = select()
    if not certify:
        return SweepResult(st1.dist, st1.idx, None, -1, settled=st1)

    # the proof (module docstring): maxd kept per snapshot and liveness
    maxd = None
    if metric != "cosine":
        key = ("row_major_maxd", -1 if masked else int(hw))
        maxd = None if prep_cache is None else prep_cache.get(key)
        if maxd is None:
            maxd = _row_maxd(sq_norms, live, dp)
            if prep_cache is not None:
                prep_cache[key] = maxd   # GIL-atomic; a racing reader recomputes
    dq = None
    if data.dtype != torch.float32:     # phase 1 scores the query rounded to the rows' type
        dq = torch.linalg.vector_norm(q_live - qtarr[:, :nq].T, dim=1)
    proof = _Proof(metric, maxd, qn_row[:, 0], dq, dp)

    def prove(dist, thresh, sub=None):
        return (proof if sub is None else proof.rows(sub)).proven(dist[:, k - 1], thresh)

    okq = prove(st1.dist, th1)

    def exact_fallback(fetch_, keys):
        # the scan with the f32 query, as the rescan scores it (the gate's scan above
        # rounds it to the rows' type, as the JAX package's does); it settles its flags
        d, i, key = exact_knn(q_live, data, live, sq_norms, k=k, metric=metric,
                              db_tile=8 * tile, round_query=False, with_key=True)
        d, i, key = fetch_(d, i, key) if keys else (*fetch_(d, i), None)
        return d, i, 2, key

    # the sweep's ladder and gates, on the padded batch B
    s1_w = min(min(2 * k, k + 16), wmin1t.shape[0])
    s2_w = min(8 * s1_w, wmin1t.shape[0])
    escalate = _ladder(st1, okq, lambda sub: select(s2_w, sub), prove, exact_fallback,
                       tier2_exists=s2_w > s1_w and B * s2_w * r1 <= cap,
                       contain=B > FQ_CONTAIN)
    return SweepResult(st1.dist, st1.idx, okq, 0, escalate, settled=st1)
