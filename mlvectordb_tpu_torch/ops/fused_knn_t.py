"""Certified sweep exact k-NN in torch + CUDA: the counterpart of
``mlvectordb_tpu/ops/pallas_knn_t.py``.

The store keeps f32 rows for the rescan and, beside them, a sweep mirror in one of three
types (``EngineConfig.sweep_dtype``):
  bf16  — the rows rounded to bf16, with int8 codes of each row's rounding residual
          (``quantize_resid_rows``); over a bf16 store (``dtype="bfloat16"``) the mirror
          is the store's own rows and the rescan reads them too: the same-dtype sweep,
          one pass, whose certificate carries the query's bf16 rounding alone;
  int8  — row-wise int8 codes ``row ~ s1*z1`` (``quantize_int8_rows``), with a second
          stream ``+ s2*z2`` of the remainder under ``sweep_resid``
          (``quantize_int8_resid_rows``): 2 B/element in place of bf16's 3;
  f32   — the rows themselves (the store's own tensor: no copy); over a bf16 store an
          f32 tensor of its own.
Every mirror, its certificate arrays and the store's norms are computed from the stored
rows, at write time as at a rebuild (store/namespace.py), so the JAX package's certificate
plan (``_plan``) holds over the rows the rescan scores; the one term it lacks is the
same-dtype sweep's norm gap (ROADMAP C2).  A search runs:

  phase 1  — kernels B1/B3 (``csrc/sweep_min.cu``, ``_window_mins_t``): one pass over the
             mirror ranks every row against every folded query and writes only the min
             over each window of r1 consecutive rows, lowered by the row's own error
             bound (the certificate's optimistic bound).  Light: one pass.  Heavy: plus
             the query's bf16 residual and the int8 residual codes.  ``_plan`` derives
             the program from the mirror's type as the JAX package does.  A bf16 or
             int8 mirror's products run on the tensor cores (bf16 mma, f32 sums), an f32
             mirror's on the CUDA cores.  Only the live query columns are computed; the
             engine's zero-padded rows take one cached zero-query column.
  phase 2  — window selection (torch, small tensors): two-level over the window mins, or
             one narrow top-s over the kernel's per-tile top-m candidate pool where the
             JAX package gates the pool on; then the exact f32 rescan of the selected
             windows through kernel B2 (``csrc/gather_score.cu``, ``_gather_score``), then
             the per-query certificate ``okq``.
  escalate — only after a proof failed: the contained or widened selection (tier 1), then
             the exact scan (tier 2).
Phase 1, phase 2 and the proof run under the spans ``sweep.phase1``, ``sweep.rescan`` and
``sweep.proof`` (``utils/tracing``); the kernels' launches are counted (``kernel_counts``).

Layout.  The mirror is ROW-major ``[cap, Dp]``: window f is rows ``[f*r1, (f+1)*r1)``,
the same window set as the JAX package's window-major ``[Dp, cap]`` layout, which exists
only because Mosaic reduces over lane slices.  Per-row vectors stay in store-row order.
The window mins come out tile-major ``[nt, B, g*128]`` with the JAX package's position
map (``_pos_to_window``), so the selection code and the element-by-element tests carry
over unchanged.  Kernel B1 also writes the JAX package's non-transposed ``[B, nt*g*128]``
form (``transposed=False``, the same positions), which probe B6 (``probes/out_layout``)
times against tile-major; the search keeps tile-major, which the card ran no slower
(PERF.md, the B6 layout decision).

Each kernel wrapper launches its CUDA kernel for a CUDA tensor and runs its plain torch
version (``*_ref``) for a CPU tensor; there is no fallback between the two.

Control flow.  ``jax.lax.cond`` has no eager counterpart: choosing the tier means reading
the per-query proof on the host.  ``exact_knn_t(..., defer=True)`` therefore returns a
``SweepResult`` holding the tier-1 ``(dist, idx)``, ``okq`` and the float64 settle's flags
(``need``, ROADMAP C18) on the device, so the engine brings them down in its one packed
copy; ``SweepResult.finish`` escalates only after a proof has failed, or settles a flagged
query wider, and reports each further copy through the caller's ``fetch``.

The JAX package's ``MLVDB_*`` environment globals are the fields of ``Tuning``, passed
explicitly, with the JAX defaults; ``Tuning(topm_enable=False)`` is its ``MLVDB_TOPM=0``
program.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from . import _kernels
from .distances import MASKED, require_f32_matmul
from .settle import U, Settled, widen_host
from .topk import exact_knn
from ..utils.tracing import trace_span

SWEEP_TILE = 4096           # rows per tile of the tile-major window-min output
R1MAX = 32                  # widest window
WLANE = SWEEP_TILE // R1MAX  # 128 windows per output block
Q_TILE = 256                # query tile of the JAX shape gate (B % min(256, B) == 0)
R2 = 32                     # fine windows per level-2 selection block
FQ_CONTAIN = 8              # queries re-proved by the contained escalation
LIVE_STEP = 8               # query columns of one tensor-core n-tile: the live count's step


class Tuning(NamedTuple):
    """The selection knobs the JAX package reads from ``MLVDB_*`` variables, as explicit
    arguments with its defaults (pallas_knn_t.py:532-558)."""

    sort_topk_from: int = 257   # kk at or above which selections sort instead of top-k
    blocktop: bool = True       # block-top refine for wide certified selections
    mb_blocktop: int = 8        # windows each selected block yields in that refine
    contain: bool = True        # per-query contained escalation
    topm_enable: bool = True    # per-tile top-m candidate pool for tier 1 (MLVDB_TOPM)


DEFAULT_TUNING = Tuning()


def _topm_sub_rows(m: int) -> int:
    """Rows of the pool's output block per tile (pallas_knn_t.py:215-218): m value rows +
    ceil(m/2) packed-position rows, padded up to a multiple of 8."""
    return -(-(m + (m + 1) // 2) // 8) * 8


# ------------------------------------------------------------------ mirror upkeep

def sweep_err_norms(data: torch.Tensor) -> torch.Tensor:
    """Per-row ``||row - bf16(row)||`` (pallas_knn_t.py:106-111)."""
    d32 = data.float()
    delta = d32 - d32.to(torch.bfloat16).float()
    return torch.sqrt((delta * delta).sum(-1))


def _codes(x: torch.Tensor):
    """Row-wise int8 codes of ``x`` [n, Dp] f32, the JAX package's quantizer step
    (pallas_knn_t.py:120-127): ``(z [n, Dp] int8, scale [n], ||x - scale*z|| [n])`` with
    scale = max|x| / 127.  ``torch.round`` rounds half to even, as ``jnp.round`` does, so
    the codes are the JAX package's bit for bit.  The scale is divided by a tensor:
    CUDA turns a division by a Python scalar into a product with its reciprocal, which
    is 1 ulp off the division on some rows."""
    amax = x.abs().amax(-1)
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))[:, None]
    z = torch.clamp(torch.round(x / safe), -127.0, 127.0)
    z = torch.where(scale[:, None] > 0, z, torch.zeros_like(z))
    rem = x - scale[:, None] * z
    return z.to(torch.int8), scale, torch.sqrt((rem * rem).sum(-1))


def quantize_resid_rows(vals: torch.Tensor):
    """Row-wise int8 codes of the bf16 rounding residual (pallas_knn_t.py:170-186):
    ``(z [n, Dp] int8, scale [n] f32, err2 [n] f32, err1 [n] f32)`` with
    delta = row - bf16(row) ~ scale * z, err2 = ||delta - scale*z|| and err1 = ||delta||."""
    v32 = vals.float()
    delta = v32 - v32.to(torch.bfloat16).float()
    e1 = torch.sqrt((delta * delta).sum(-1))
    z, scale, e2 = _codes(delta)
    return z, scale, e2, e1


def quantize_int8_rows(vals: torch.Tensor):
    """The int8 primary mirror (pallas_knn_t.py:114-127): ``(z [n, Dp] int8,
    scale [n] f32, err [n] f32)`` with row ~ scale * z and err = ||row - scale*z||, the
    certificate's data-side bound."""
    return _codes(vals.float())


def quantize_int8_resid_rows(vals: torch.Tensor):
    """The two-level int8 mirror (pallas_knn_t.py:137-156): row ~ s1*z1 + s2*z2, where
    z2 codes delta1 = row - s1*z1 with its own scale.  Returns ``(z1, s1, z2, s2, err2,
    err1)``: codes [n, Dp] int8, the rest [n] f32, err2 = ||delta1 - s2*z2|| and
    err1 = ||delta1||."""
    v32 = vals.float()
    z1, s1, e1 = _codes(v32)
    z2, s2, e2 = _codes(v32 - s1[:, None] * z1.float())
    return z1, s1, z2, s2, e2, e1


def _pick_r1(batch: int, n_rows: int, k: int) -> int:
    """Window width of the sweep path (pallas_knn_t.py:1352-1374): wide windows for small
    k, narrow ones for large k, widened until the window-min matrix fits in 2 GB."""
    if k <= 16:
        r1 = 32
    elif k <= 128:
        r1 = 16
    elif k <= 256:
        r1 = 8
    else:
        r1 = 4
    while r1 < R1MAX and batch * n_rows * 4 // r1 > (1 << 31):
        r1 *= 2
    return r1


# ------------------------------------------------------------------ kernel B1

# rows per chunk of the plain version's [rows, B] rank block
_REF_CHUNK_ELEMS = 1 << 25


def _topm_pool_ref(wmin_t, m: int):
    """The per-tile top-m pool of the window mins ``wmin_t`` [nt, B, out_w] as the JAX
    kernel's epilogue forms it (pallas_knn_t.py:343-380), returned [nt, SUB, B]: for each
    tile and query the m smallest (value, position) pairs in (value, position) order, by
    one stable sort.  m rounds of min / first-argmin / mask give +inf entries at position
    0, and a tile holding a NaN min NaN values at position out_w.  Rows 0..m-1 hold the
    values, rows m.. the positions packed two per f32 as p0 + out_w*p1, the rest +inf."""
    nt, B, out_w = wmin_t.shape
    inf = float("inf")
    sv, si = torch.sort(wmin_t, dim=-1, stable=True)
    v, p = sv[..., :m], si[..., :m]
    p = torch.where(v == inf, 0, p)
    nan = torch.isnan(wmin_t).any(-1, keepdim=True)
    v = torch.where(nan, float("nan"), v)
    p = torch.where(nan, out_w, p)
    if m % 2:
        p = torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)
    packed = (p[..., 0::2] + out_w * p[..., 1::2]).to(torch.float32)  # exact: < 2^24
    pool = wmin_t.new_full((nt, _topm_sub_rows(m), B), inf)
    pool[:, :m] = v.permute(0, 2, 1)
    pool[:, m : m + packed.shape[-1]] = packed.permute(0, 2, 1)
    return pool


def _decode_topm(topm, m: int, out_w: int):
    """The pool [nt, SUB, B] as (values [nt, m, B], positions within the tile [nt, m, B]
    int32), the packed rows split as the JAX package splits them (pallas_knn_t.py:883-891)."""
    npack = (m + 1) // 2
    pk = topm[:, m : m + npack].to(torch.int32)           # exact: < out_w^2 <= 2^24
    pos = torch.stack([pk % out_w, pk // out_w], dim=2).reshape(topm.shape[0], 2 * npack, -1)
    return topm[:, :m], pos[:, :m]


def _window_mins_t_ref(qh, qres, mirror, resid, rscale, scale, bias, *, r1,
                       emit_block_mins=False, emit_topm=0, skip_wm=False, qe=None,
                       eb_rows=(), transposed=True):
    """Plain torch version of kernels B1/B3: f32 matmuls of the operands converted to f32
    (bf16, int8 or f32 mirror) per chunk of whole tiles, the kernel's formula, then the
    min over each r1-row window, written tile-major (or ``[B, P]``); the block mins and
    the top-m pool from those mins."""
    _check_outputs(emit_block_mins, emit_topm, skip_wm, transposed)
    require_f32_matmul()
    cap, Dp = mirror.shape
    B = qh.shape[0]
    g = R1MAX // r1
    nt = cap // SWEEP_TILE
    qh32 = qh.float().T
    qr32 = None if qres is None else qres.float().T
    out = torch.empty((nt, B, g * WLANE), dtype=torch.float32, device=mirror.device)
    tiles = max(1, _REF_CHUNK_ELEMS // max(B, 1) // SWEEP_TILE)
    for t0 in range(0, nt, tiles):
        t1 = min(nt, t0 + tiles)
        rows = slice(t0 * SWEEP_TILE, t1 * SWEEP_TILE)
        m = mirror[rows].float()
        dots = m @ qh32                                           # [n, B]
        if qr32 is not None:
            dots = dots + m @ qr32
        if resid is not None:
            dots = dots + (resid[rows].float() @ qh32) * rscale[rows, None]
        rank = dots
        if scale is not None:
            rank = rank * scale[rows, None]
        if bias is not None:
            rank = rank + bias[rows, None]
        for t, eb in enumerate(eb_rows):
            rank = rank - qe[:, t][None, :] * eb[rows, None]
        wm = rank.reshape(-1, r1, B).amin(1)                      # [windows, B]
        # local window lf = j*g + a of tile t -> output lane a*128 + j
        out[t0:t1] = wm.reshape(t1 - t0, WLANE, g, B).permute(0, 3, 2, 1).reshape(
            t1 - t0, B, g * WLANE)
    if not transposed:
        return out.permute(1, 0, 2).reshape(B, nt * g * WLANE), None, None   # [B, P]
    bm = out.amin(-1) if emit_block_mins else None                # [nt, B]
    pool = _topm_pool_ref(out, emit_topm) if emit_topm else None  # [nt, SUB, B]
    return None if skip_wm else out, bm, pool


def _phase1_budget(qh, qres, mirror, resid, rscale, scale, bias, *, r1, qe=None, eb_rows=(),
                   transposed=True):
    """Per-element bound on |kernel - plain| of B1/B3's window mins, shaped as they are.

    Each pass's dot is within Dp * 2^-23 * |a||b| of the exact one on the tensor cores
    (the bar ``chip_smoke.py`` measures) and within Dp * 2^-24 * |a||b| in the plain
    version's f32 sums; the epilogue's roundings add 2^-21 of each term's magnitude.  A
    window min moves by at most the largest of its live rows' bounds (min is 1-Lipschitz);
    masked rows (bias >= MASKED / 2) never hold a live window's min.  The bound of a block
    min is the largest over its windows: ``budget.amax(-1)``."""
    cap, Dp = mirror.shape
    g = R1MAX // r1
    nt = cap // SWEEP_TILE
    tc, eps = Dp * (2.0 ** -23 + 2.0 ** -24), 2.0 ** -21
    dev = mirror.device

    def norms(x):   # row norms, 2^20 rows at a time
        return torch.cat([torch.linalg.vector_norm(x[i:i + (1 << 20)].float(), dim=1)
                          for i in range(0, x.shape[0], 1 << 20)])

    s = torch.ones(cap, device=dev) if scale is None else scale.abs()
    v = norms(mirror) * s                                      # qh.m and qres.m
    u = v if resid is None else v + norms(resid) * rscale.abs() * s
    live = torch.ones(cap, dtype=torch.bool, device=dev) if bias is None else bias < MASKED / 2

    def wmax(x):    # [cap] -> the largest over each window's live rows, tile-major [nt, 1, gw]
        x = torch.where(live, x, torch.zeros_like(x)).reshape(-1, r1).amax(1)
        return x.reshape(nt, WLANE, g).permute(0, 2, 1).reshape(nt, 1, g * WLANE)

    def qcol(x):    # [B] -> [1, B, 1]
        return x[None, :, None]

    out = (tc + eps) * qcol(torch.linalg.vector_norm(qh.float(), dim=1)) * wmax(u)
    if qres is not None:
        out = out + (tc + eps) * qcol(torch.linalg.vector_norm(qres.float(), dim=1)) * wmax(v)
    if bias is not None:
        out = out + eps * wmax(bias.abs())
    for t, eb in enumerate(eb_rows):
        out = out + eps * qcol(qe[:, t].abs()) * wmax(eb.abs())
    if not transposed:
        return out.permute(1, 0, 2).reshape(qh.shape[0], nt * g * WLANE)
    return out


def _check_outputs(emit_block_mins, emit_topm, skip_wm, transposed=True):
    """The output combinations the JAX package takes (pallas_knn_t.py:415-420)."""
    if emit_topm and emit_block_mins:
        raise ValueError("the top-m pool is never emitted beside the block mins")
    if skip_wm and not emit_topm:
        raise ValueError("skip_wm needs the top-m pool as the remaining output")
    if not transposed and (emit_block_mins or emit_topm):
        raise ValueError("the block mins and the pool need the tile-major output")


# the kernel's mirror types: its code, and the query type the plan gives each
# (pallas_knn_t.py:1078: an int8 mirror is ranked against bf16 queries)
_MIRROR_TYPES = {torch.bfloat16: (0, torch.bfloat16), torch.int8: (1, torch.bfloat16),
                 torch.float32: (2, torch.float32)}


def _check_sweep_operands(qh, qres, mirror, resid, rscale, scale, bias, qe, eb_rows, r1,
                          emit_block_mins, emit_topm=0, skip_wm=False, transposed=True):
    """Raise on anything kernels B1/B3 do not take: per mirror type, its query type and
    its passes (bf16: any; int8: one pass, two_pass, or two_pass with the residual
    codes; f32: one pass)."""
    _check_outputs(emit_block_mins, emit_topm, skip_wm, transposed)
    if emit_topm and (emit_topm % 2 or not 8 <= emit_topm <= 32
                      or emit_topm * (R1MAX // max(r1, 1)) > 32):
        raise ValueError(f"the kernel's pool needs an even m in 8..32 with m * (32 / r1) "
                         f"<= 32; got m={emit_topm} r1={r1}")
    if mirror.dtype not in _MIRROR_TYPES:
        raise ValueError(f"mirror must be bf16, int8 or f32; got {mirror.dtype}")
    q_dtype = _MIRROR_TYPES[mirror.dtype][1]
    if (mirror.dtype == torch.float32 and (qres is not None or resid is not None)) or (
            mirror.dtype == torch.int8 and resid is not None and qres is None):
        raise ValueError(f"the kernel has no such program for a {mirror.dtype} mirror: "
                         f"qres {qres is not None}, resid {resid is not None}")
    cap, Dp = mirror.shape
    B = qh.shape[0]
    dev = mirror.device
    want = {"qh": (qh, q_dtype, (B, Dp)), "mirror": (mirror, mirror.dtype, (cap, Dp))}
    if bias is not None:
        want["bias"] = (bias, torch.float32, (cap,))
    if qres is not None:
        want["qres"] = (qres, q_dtype, (B, Dp))
    if resid is not None:
        want["resid"] = (resid, torch.int8, (cap, Dp))
        want["rscale"] = (rscale, torch.float32, (cap,))
    if scale is not None:
        want["scale"] = (scale, torch.float32, (cap,))
    for t, eb in enumerate(eb_rows):
        want[f"eb{t + 1}"] = (eb, torch.float32, (cap,))
    if eb_rows:
        want["qe"] = (qe, torch.float32, (B, len(eb_rows)))
    for name, (t, dtype, shape) in want.items():
        if t is None or t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if (r1 not in (1, 2, 4, 8, 16, 32) or cap % SWEEP_TILE or cap == 0 or Dp % 128
            or len(eb_rows) > 2 or B == 0 or (emit_block_mins and r1 != R1MAX)):
        raise ValueError(
            f"kernel needs r1 in 1..32 (powers of two), cap % {SWEEP_TILE} == 0, Dp % 128 "
            f"== 0, at most 2 bound rows and block mins only at r1 = 32; got cap={cap} "
            f"Dp={Dp} B={B} r1={r1} n_eb={len(eb_rows)} block_mins={emit_block_mins}")


def _query_rows(x: torch.Tensor, n_c: int) -> torch.Tensor:
    """Kernel B1/B3's query operand from the first ``n_c`` rows of ``x`` [B, Dp] (bf16; f32
    for an f32 mirror, which the kernel splits into bf16 parts itself): [Bq, Dp] of x's
    type, Bq = n_c rounded up to ``LIVE_STEP``, zero past n_c."""
    bq = -(-n_c // LIVE_STEP) * LIVE_STEP
    if bq == n_c:
        return x[:n_c]
    t = torch.zeros((bq, x.shape[1]), dtype=x.dtype, device=x.device)
    t[:n_c] = x[:n_c]
    return t


def _live_columns(batch: int, n_live) -> int:
    """The query columns a launch computes: ``n_live`` rounded up to the tensor-core
    product's n (``LIVE_STEP``), at most the batch; every column when ``n_live`` is None."""
    if n_live is None:
        return batch
    return min(batch, -(-max(int(n_live), 1) // LIVE_STEP) * LIVE_STEP)


def sweep_route(mirror_dtype, dim: int, n_live, batch: int, *, two_pass: bool,
                resid: bool) -> dict:
    """The route kernel B1/B3 takes for the program (``two_pass``: a qres operand,
    ``resid``: the residual codes) over a ``mirror_dtype`` mirror of ``dim`` dimensions, on
    the columns a launch of ``batch`` queries with ``n_live`` live computes: the queries a
    block owns, its ring depth, and whether its query tile streams through the block or
    sits in shared memory.  Asks the built library (on the machine with the card)."""
    bq = -(-_live_columns(batch, n_live) // LIVE_STEP) * LIVE_STEP
    code = _kernels.library().mlvdb_sweep_route(dim, bq, _MIRROR_TYPES[mirror_dtype][0],
                                                int(two_pass), int(resid))
    if code < 0:
        raise ValueError(f"the kernel has no such program: {mirror_dtype} Dp={dim} "
                         f"two_pass={two_pass} resid={resid}")
    return {"tile_queries": code // 100, "stages": code // 10 % 10,
            "query": "streamed" if code % 10 else "resident"}


def _sweep_launch(qh, qres, mirror, resid, rscale, scale, bias, *, r1, emit_block_mins,
                  emit_topm, skip_wm, qe, eb_rows, transposed, n_c):
    """Launch kernel B1/B3 on the first ``n_c`` query columns of outputs ``B = len(qh)``
    wide; the columns from ``n_c`` on are left unwritten.  Returns the outputs."""
    _check_sweep_operands(qh, qres, mirror, resid, rscale, scale, bias, qe, eb_rows, r1,
                          emit_block_mins, emit_topm, skip_wm, transposed)
    cap, Dp = mirror.shape
    B = qh.shape[0]
    g = R1MAX // r1
    nt = cap // SWEEP_TILE
    dev = mirror.device
    bq = -(-n_c // LIVE_STEP) * LIVE_STEP
    qe_p = torch.zeros((bq, 2), dtype=torch.float32, device=dev)
    if eb_rows:
        qe_p[:n_c, : len(eb_rows)] = qe[:n_c]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    if skip_wm:
        out = None
    else:
        out = empty(nt, B, g * WLANE) if transposed else empty(B, nt * g * WLANE)
    bm = empty(nt, B) if emit_block_mins else None
    pool = empty(nt, _topm_sub_rows(emit_topm), B) if emit_topm else None
    qh_op, qres_op = _query_rows(qh, n_c), (None if qres is None else _query_rows(qres, n_c))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):  # the C launch uses the runtime's current device
        rc = _kernels.library().mlvdb_sweep_min(
            qh_op.data_ptr(), ptr(qres_op), mirror.data_ptr(), ptr(resid), ptr(rscale),
            ptr(scale), ptr(bias), qe_p.data_ptr(), ptr(eb_rows[0] if eb_rows else None),
            ptr(eb_rows[1] if len(eb_rows) > 1 else None), ptr(out), ptr(bm), ptr(pool),
            cap, Dp, B, n_c, bq, r1, len(eb_rows), emit_topm, _MIRROR_TYPES[mirror.dtype][0],
            int(not transposed), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"sweep_min launch failed: cudaError {rc}")
    return out, bm, pool


def _zero_query_outputs(qh, qres, mirror, resid, rscale, scale, bias, *, qe, eb_rows,
                        n_live, zero_cache, plain, **opts):
    """The outputs of the padded query row ``n_live`` (the engine's zero query), one
    column each, computed by the kernel (``plain``: its plain version) on that row tiled
    to one query tile and kept in ``zero_cache`` (the snapshot's prep dict holds it)
    under the program's key.  Counted on ``_window_mins_t.launches_zero`` where the
    kernel ran."""
    key = ("zero_query", opts["r1"], qres is not None, resid is not None, str(mirror.dtype),
           opts["emit_block_mins"], opts["emit_topm"], opts["skip_wm"], opts["transposed"])
    hit = None if zero_cache is None else zero_cache.get(key)
    if hit is not None:
        return hit

    def row(x):
        return None if x is None else x[n_live:n_live + 1].expand(LIVE_STEP, -1).contiguous()

    args = (row(qh), row(qres), mirror, resid, rscale, scale, bias)
    kw = dict(opts, qe=row(qe), eb_rows=eb_rows)
    if plain:
        outs = _window_mins_t_ref(*args, **kw)
    else:
        outs = _sweep_launch(*args, **kw, n_c=LIVE_STEP)
        _count(_window_mins_t, _B1_LOCK, launches_zero=1)
    axes = _query_axes(opts["transposed"])
    hit = tuple(None if o is None else o.narrow(ax, 0, 1).clone() for o, ax in zip(outs, axes))
    if zero_cache is not None:
        zero_cache[key] = hit  # GIL-atomic; a racing reader recomputes
    return hit


def _query_axes(transposed):
    """The query axis of each output: window mins (tile-major or [B, P]), block mins, pool."""
    return (1 if transposed else 0, 1, 2)


def _window_mins_t(qh, qres, mirror, resid, rscale, scale, bias, *, r1,
                   emit_block_mins=False, emit_topm=0, skip_wm=False, qe=None, eb_rows=(),
                   transposed=True, n_live=None, zero_cache=None):
    """Phase 1 (pallas_knn_t._window_mins).

    qh / qres [B, Dp] (metric factor folded in; qres = compensation residual or None):
    bf16 for a bf16 or int8 mirror, f32 for an f32 one; mirror [cap, Dp] bf16, int8 or
    f32; resid [cap, Dp] int8 + rscale [cap] (or None), scale [cap] (cosine and the int8
    dequant scale, or None), bias [cap] (or None: rank = dots), qe [B, n_eb] + eb_rows
    (n_eb [cap] rows).
    rank = (qh.m [+ qres.m] [+ (qh.resid)*rscale]) [*scale] + bias - sum_t qe_t*eb_t.
    ``emit_topm=m``: also the per-tile top-m pool; ``skip_wm``: the pool only.
    Returns ``(wmin_t [nt, B, g*128] or None, block_mins [nt, B] or None,
    pool [nt, SUB, B] or None)``; ``transposed=False``: ``(wmin [B, nt*g*128], None,
    None)``, the JAX package's non-transposed output.  The CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor.

    ``n_live``: rows ``[n_live, B)`` are the engine's padding, each the folded zero
    query.  Only the first ``_live_columns(B, n_live)`` columns are computed; the rest
    are filled from the zero query's outputs, cached in ``zero_cache`` (a dict, or None
    to compute them here).  Every output keeps its B-wide shape and the values a full
    call gives those rows."""
    kw = dict(r1=r1, emit_block_mins=emit_block_mins, emit_topm=emit_topm, skip_wm=skip_wm,
              qe=qe, eb_rows=eb_rows, transposed=transposed, n_live=n_live,
              zero_cache=zero_cache)
    if mirror.device.type == "cpu":
        return _window_mins_t_plain(qh, qres, mirror, resid, rscale, scale, bias, **kw)
    return _window_mins_t_kernel(qh, qres, mirror, resid, rscale, scale, bias, **kw)


def _live_split(qh, qres, mirror, resid, rscale, scale, bias, *, qe, eb_rows, n_live,
                zero_cache, plain, **opts):
    """(live columns, the zero query's outputs or None) of one call (``_window_mins_t``)."""
    _check_outputs(opts["emit_block_mins"], opts["emit_topm"], opts["skip_wm"],
                   opts["transposed"])
    n_c = _live_columns(qh.shape[0], n_live)
    zero = None
    if n_c < qh.shape[0]:
        zero = _zero_query_outputs(qh, qres, mirror, resid, rscale, scale, bias, qe=qe,
                                   eb_rows=eb_rows, n_live=n_live, zero_cache=zero_cache,
                                   plain=plain, **opts)
    return n_c, zero


def _window_mins_t_plain(qh, qres, mirror, resid, rscale, scale, bias, *, r1,
                         emit_block_mins=False, emit_topm=0, skip_wm=False, qe=None,
                         eb_rows=(), transposed=True, n_live=None, zero_cache=None):
    """The plain version of ``_window_mins_t``, on any device: ``_window_mins_t_ref`` on
    the live columns, the padded ones from the zero query's plain outputs."""
    opts = dict(r1=r1, emit_block_mins=emit_block_mins, emit_topm=emit_topm, skip_wm=skip_wm,
                transposed=transposed)
    n_c, zero = _live_split(qh, qres, mirror, resid, rscale, scale, bias, qe=qe,
                            eb_rows=eb_rows, n_live=n_live, zero_cache=zero_cache,
                            plain=True, **opts)
    B = qh.shape[0]

    def cut(x):
        return None if x is None else x[:n_c]

    outs = _window_mins_t_ref(qh[:n_c], cut(qres), mirror, resid, rscale, scale, bias,
                              qe=cut(qe), eb_rows=eb_rows, **opts)
    if zero is None:
        return outs
    return tuple(None if o is None else torch.cat(
        [o, z.expand(*[B - n_c if d == ax else s for d, s in enumerate(o.shape)])], dim=ax)
        for o, z, ax in zip(outs, zero, _query_axes(transposed)))


def _window_mins_t_kernel(qh, qres, mirror, resid, rscale, scale, bias, *, r1,
                          emit_block_mins=False, emit_topm=0, skip_wm=False, qe=None,
                          eb_rows=(), transposed=True, n_live=None, zero_cache=None):
    """The CUDA path of ``_window_mins_t``: the kernel on the live columns, the padded
    ones filled from the zero query's outputs; every launch counted."""
    opts = dict(r1=r1, emit_block_mins=emit_block_mins, emit_topm=emit_topm, skip_wm=skip_wm,
                transposed=transposed)
    n_c, zero = _live_split(qh, qres, mirror, resid, rscale, scale, bias, qe=qe,
                            eb_rows=eb_rows, n_live=n_live, zero_cache=zero_cache,
                            plain=False, **opts)
    B = qh.shape[0]
    outs = _sweep_launch(qh, qres, mirror, resid, rscale, scale, bias, qe=qe,
                         eb_rows=eb_rows, n_c=n_c, **opts)
    _count(_window_mins_t, _B1_LOCK, launches=1, cols=n_c, launches_bp=int(not transposed),
           launches_heavy=int(qres is not None or resid is not None),
           launches_topm=int(bool(emit_topm)), launches_int8=int(mirror.dtype == torch.int8),
           launches_f32=int(mirror.dtype == torch.float32))
    if zero is not None:
        for o, z, ax in zip(outs, zero, _query_axes(transposed)):
            if o is not None:
                pad = o.narrow(ax, n_c, B - n_c)
                pad.copy_(z.expand_as(pad))
    return outs


def _count(fn, lock, **adds) -> None:
    """Add ``adds`` to the counters kept as ``fn``'s attributes, under ``lock``: clients
    on several threads launch at once, and ``+=`` on an attribute is a read and a write
    that another thread's update can fall between."""
    with lock:
        for name, n in adds.items():
            setattr(fn, name, getattr(fn, name) + n)


# kernel launches so far: all variants (not the zero-query fills), the heavy ones, those
# that emitted the top-m pool, those over an int8 or an f32 mirror, those that wrote the
# [B, P] form; the query columns those launches computed; and the launches that filled a
# zero-query cache (a run resets and reads these; updated under _B1_LOCK)
_B1_LOCK = threading.Lock()
_window_mins_t.launches = 0
_window_mins_t.cols = 0
_window_mins_t.launches_bp = 0
_window_mins_t.launches_heavy = 0
_window_mins_t.launches_topm = 0
_window_mins_t.launches_int8 = 0
_window_mins_t.launches_f32 = 0
_window_mins_t.launches_zero = 0


# ------------------------------------------------------------------ kernel B2

def _gather_rows(B, n_live):
    """The query rows kernel B2 computes: the live ones and the first padded row (every
    row when ``n_live`` is None or covers the batch)."""
    return B if n_live is None or n_live >= B else n_live + 1


def _gather_score_ref(q32, data, f, *, r1, n_live=None):
    """Plain torch version of kernel B2 (pallas_knn_t._rescan_windows._score): gather
    the r1 rows (f32 or bf16, read as f32) of each candidate window ``f`` [B, s1] and
    return per-row ``(q . row, ||row||^2)`` [B, s1*r1] in f32.  ``n_live``: rows from it
    on are the engine's zero padding, zero queries over one row's windows (raises if they
    are not); only the first of them is computed, and the rest are its copies."""
    require_f32_matmul()
    n_c = _gather_rows(f.shape[0], n_live)
    B, s1 = f.shape
    if n_c < B and (bool(q32[n_live:].any()) or not bool((f[n_live:] == f[n_live]).all())):
        raise ValueError("gather_score: rows from n_live on must be zero queries over one "
                         "row's windows")
    w = torch.clamp(f[:n_c].long(), 0, data.shape[0] // r1 - 1)   # as XLA's gather clamps
    rows = (w[:, :, None] * r1 + torch.arange(r1, device=f.device)).reshape(-1)
    sub = data.index_select(0, rows).float().reshape(n_c, s1 * r1, -1)
    out = torch.empty((2, B, s1 * r1), dtype=torch.float32, device=f.device)
    out[0, :n_c] = (sub * q32[:n_c, None, :]).sum(-1)
    out[1, :n_c] = (sub * sub).sum(-1)
    out[:, n_c:] = out[:, n_c - 1:n_c]
    return out[0], out[1]


def _check_gather_operands(q32, data, f, r1):
    """Raise on anything kernel B2 does not take."""
    cap, Dp = data.shape
    B, s1 = f.shape
    rows = data.dtype if data.dtype in _kernels.ROW_TYPES else torch.float32
    for name, t, dtype in (("q32", q32, torch.float32), ("data", data, rows),
                           ("f", f, torch.int32)):
        if t.device != data.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {data.device}")
    if tuple(q32.shape) != (B, Dp) or Dp % 128 or r1 <= 0 or cap % r1 or B == 0 or s1 == 0:
        raise ValueError(f"gather_score needs q32 [B, Dp] with Dp % 128 == 0 and cap % r1 "
                         f"== 0; got q32 {tuple(q32.shape)}, data {tuple(data.shape)}, "
                         f"f {tuple(f.shape)}, r1={r1}")
    if data.data_ptr() % 16 or q32.data_ptr() % 16:
        raise ValueError("gather_score's 16-byte loads need q32 and data 16-byte aligned")


def _gather_score(q32, data, f, *, r1, n_live=None):
    """Kernel B2 (the port of pallas_gather.gather_score): ``(dots, sqn)`` [B, s1*r1],
    column j*r1 + i = row i of window f[:, j].  ``n_live``: rows from it on are the
    engine's zero padding, whose windows are one row's copies; only the first padded row
    is computed, and the kernel copies its outputs to the rest.  The CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if data.device.type == "cpu":
        return _gather_score_ref(q32, data, f, r1=r1, n_live=n_live)
    _check_gather_operands(q32, data, f, r1)
    cap, Dp = data.shape
    B, s1 = f.shape
    n_c = _gather_rows(B, n_live)
    out = torch.empty((2, B, s1 * r1), dtype=torch.float32, device=data.device)
    with torch.cuda.device(data.device):
        rc = _kernels.library().mlvdb_gather_score(
            q32.data_ptr(), data.data_ptr(), f.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            n_c, B, s1, r1, Dp, cap // r1, _kernels.ROW_TYPES[data.dtype],
            torch.cuda.current_stream(data.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"gather_score launch failed: cudaError {rc}")
    _count(_gather_score, _B2_LOCK, launches=1, launches_bf16=int(data.dtype == torch.bfloat16),
           rows=n_c * s1 * r1)
    return out[0], out[1]


# launches so far, those over bf16 rows, and the candidate rows the launches computed
# (updated under _B2_LOCK)
_B2_LOCK = threading.Lock()
_gather_score.launches = _gather_score.launches_bf16 = _gather_score.rows = 0

# kernel_counts()'s names for the counters: B1/B3's, then B2's
_B1_COUNTS = {"launches": "launches", "heavy": "launches_heavy", "topm": "launches_topm",
              "int8": "launches_int8", "f32": "launches_f32", "bp": "launches_bp",
              "cols": "cols", "zero_query": "launches_zero"}
_B2_COUNTS = {"launches": "launches", "bf16": "launches_bf16", "rows": "rows"}


def kernel_counts() -> Dict[str, Dict[str, int]]:
    """The process's counts of CUDA launches of kernels B1/B3 (``sweep_min``) and B2
    (``gather_score``), each kernel's read at one moment under its lock.  ``sweep_min``:
    ``launches`` (every variant, not the zero-query fills), ``light`` (one pass) and
    ``heavy`` (with the query's residual or the residual codes), ``topm`` (emitted the
    top-m pool), ``int8`` / ``f32`` (over such a mirror), ``bp`` (wrote the ``[B, P]``
    form), ``cols`` (query columns computed), ``zero_query`` (fills of a zero-query
    cache).  ``gather_score``: ``launches``, ``bf16`` (over bf16 rows), ``rows``
    (candidate rows scored).  The plain versions, which CPU tensors run, count nothing."""
    with _B1_LOCK:
        b1 = {k: int(getattr(_window_mins_t, a)) for k, a in _B1_COUNTS.items()}
    with _B2_LOCK:
        b2 = {k: int(getattr(_gather_score, a)) for k, a in _B2_COUNTS.items()}
    b1["light"] = b1["launches"] - b1["heavy"]
    return {"sweep_min": b1, "gather_score": b2}


# ------------------------------------------------------------------ phase 2 selection

def _pos_to_window(p, g: int):
    """Output position -> fine window id (pallas_knn_t.py:507-514)."""
    gw = g * WLANE
    t = p // gw
    rem = p - t * gw
    a = rem // WLANE
    j = rem - a * WLANE
    return (t * WLANE + j) * g + a


def _sorted_topk(x, kk: int):
    """(values, positions) of the kk smallest per row by one stable sort."""
    sv, si = torch.sort(x, dim=-1, stable=True)
    return sv[:, :kk], si[:, :kk]


def _topk_min(x, kk: int, tuning: Tuning):
    """Smallest-kk (values, positions): top-k for small kk, a sort for large."""
    if kk >= tuning.sort_topk_from and x.shape[1] > kk:
        return _sorted_topk(x, kk)
    return torch.topk(x, kk, dim=1, largest=False)


def _topk_spec(x, kk: int, tuning: Tuning):
    """(values, idx, floor) of the kk smallest entries per row of x [B, W]
    (pallas_knn_t.py:569-610): wide rows run chunked with a speculative per-chunk width;
    every element not returned is >= min(floor, values[:, -1])."""
    B, W = x.shape
    CH = 2048
    inf = torch.full((B,), float("inf"), dtype=torch.float32, device=x.device)
    if W <= max(kk, 4096):
        v, i = _topk_min(x, min(kk, W), tuning)
        return v, i, inf
    Wp = -(-W // CH) * CH
    pad = Wp - W
    if pad:
        x = torch.cat([x, x.new_full((B, pad), float("inf"))], dim=1)
    nch = Wp // CH
    if kk <= 64:
        kc = min(kk, CH)   # exact per chunk: no chunk can hold >kk of the top-kk
    else:
        occupancy = kk // nch + 4 * math.isqrt(max(kk // nch, 1)) + 16
        guarantee = (kk + pad + nch - 1) // nch
        kc = min(CH, max(occupancy, guarantee))
    v, i = torch.topk(x.reshape(B * nch, CH), kc, dim=1, largest=False)
    vch = v.reshape(B, nch, kc)
    iglob = (i.reshape(B, nch, kc)
             + (torch.arange(nch, device=x.device) * CH)[None, :, None]).reshape(B, nch * kc)
    v2, p = _topk_min(vch.reshape(B, nch * kc), kk, tuning)
    idx = torch.clamp_max(torch.gather(iglob, 1, p), W - 1)
    floor = vch[:, :, -1].amin(1) if kc < kk else inf
    return v2, idx, floor


def _select_and_rescan(q32, qn_row, rescan, maskadd, hw, wmin_t, *, k, metric, r1, masked,
                       s_sel=None, r2=R2, spec_l2=False, wmin2=None, tuning=DEFAULT_TUNING,
                       n_live=None):
    """Hierarchical window selection on the tile-major window mins + exact rescan
    (pallas_knn_t.py:624-789).  Returns ``(settled, thresh)``: the rescan's ``Settled``
    top-k (``_rescan_settle``); every window not rescanned has (optimistic) window-min >=
    thresh, +inf when every window was.  ``n_live``: handed to the rescan."""
    nt, B, out_w = wmin_t.shape
    P = nt * out_w
    dev = q32.device
    g = R1MAX // r1
    s = min(s_sel if s_sel is not None else min(2 * k, k + 16), P)
    two_level = P % r2 == 0 and P // r2 > 1
    inf = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)

    if two_level:
        W2 = P // r2
        gb = out_w // r2                                  # blocks per tile
        if wmin2 is None:                                 # else: the kernel's block mins
            wmin2 = wmin_t.reshape(nt, B, gb, r2).amin(-1).permute(1, 0, 2).reshape(B, W2)
        s2 = min(s, W2)
        if spec_l2:
            v2, w2i, fl2 = _topk_spec(wmin2, s2, tuning)
        else:
            v2, w2i = _topk_min(wmin2, s2, tuning)
            fl2 = inf
        w2i = torch.sort(w2i, dim=1).values
        # one gathered row = one tile's out_w mins; take block w2i % gb of it
        flat = wmin_t.reshape(nt * B, out_w)
        gidx = (w2i // gb) * B + torch.arange(B, device=dev)[:, None]
        rows4 = flat.index_select(0, gidx.reshape(-1)).reshape(B, s2, gb, r2)
        if gb > 1:
            sel = (w2i % gb)[:, :, None, None].expand(B, s2, 1, r2)
            l1_blk = torch.gather(rows4, 2, sel).reshape(B, s2, r2)
        else:
            l1_blk = rows4.reshape(B, s2, r2)
        MB = tuning.mb_blocktop
        use_bt = tuning.blocktop and spec_l2 and s >= 512 and MB < r2 and W2 >= 4 * s
        if use_bt:
            # block-top refine: each selected block yields its MB smallest windows by MB
            # rounds of min / first-argmin / mask
            iota_r = torch.arange(r2, device=dev)
            work = l1_blk
            vals, poss = [], []
            for _ in range(MB):
                m1 = work.amin(2)                         # [B, s2]
                pm = torch.where(work == m1[..., None], iota_r, r2).amin(2)
                pm = torch.clamp_max(pm, r2 - 1)          # NaN rows match no lane
                vals.append(m1)
                poss.append(pm)
                work = torch.where(iota_r[None, None, :] == pm[..., None],
                                   torch.full_like(work, float("inf")), work)
            cand_v = torch.stack(vals, -1).reshape(B, s2 * MB)
            cand_p = (w2i[:, :, None] * r2 + torch.stack(poss, -1)).reshape(B, s2 * MB)
            s1 = min(s, s2 * MB)
            v1, sel = _topk_min(cand_v, s1, tuning)
            p = torch.gather(cand_p, 1, sel)
            thresh = torch.minimum(fl2, vals[-1].amin(1))
            if s2 < W2:
                thresh = torch.minimum(thresh, v2[:, -1])
            if s1 < s2 * MB:
                thresh = torch.minimum(thresh, v1[:, -1])
        else:
            s1 = min(s, s2 * r2)
            v1, pos, floor = _topk_spec(l1_blk.reshape(B, s2 * r2), s1, tuning)
            p = torch.gather(w2i, 1, pos // r2) * r2 + pos % r2   # output positions
            thresh = fl2
            if s2 < W2:
                thresh = torch.minimum(thresh, v2[:, -1])
            if s1 < s2 * r2:
                thresh = torch.minimum(thresh, v1[:, -1])
            thresh = torch.minimum(thresh, floor)
    else:
        wmin = wmin_t.permute(1, 0, 2).reshape(B, P)
        s1 = min(s, P)
        v1, p, floor = _topk_spec(wmin, s1, tuning)
        thresh = floor if s1 >= P else torch.minimum(v1[:, -1], floor)

    f = _pos_to_window(p, g)                              # [B, s1] fine windows
    return _rescan_settle(q32, qn_row, rescan, maskadd, hw, f, k=k, metric=metric, r1=r1,
                          masked=masked, n_live=n_live), thresh


def _select_topm_and_rescan(q32, qn_row, rescan, maskadd, hw, topm, *, k, metric, r1,
                            masked, s_sel, m, tuning=DEFAULT_TUNING, n_live=None):
    """Selection from the sweep kernel's per-tile top-m pool ``topm`` [nt, SUB, B] + the
    exact rescan (pallas_knn_t.py:864-906): one narrow top-s over the [B, nt*m]
    candidates.  A window never rescanned is either in the pool and not selected (>= the
    s-th selected value) or outside its tile's top m (>= that tile's m-th min >= the pool
    floor); both fold into ``thresh``, so a tile hiding more than m candidates escalates
    the certificate.  Returns ``(settled, thresh)`` as ``_select_and_rescan`` does.
    ``n_live``: handed to the rescan."""
    nt, _, B = topm.shape
    g = R1MAX // r1
    out_w = g * WLANE
    pool = nt * m
    vals_t, pos_t = _decode_topm(topm, m, out_w)          # [nt, m, B] each
    vals = vals_t.permute(2, 0, 1).reshape(B, pool)
    win = (torch.arange(nt, dtype=torch.int32, device=q32.device)[:, None, None] * out_w
           + pos_t).permute(2, 0, 1).reshape(B, pool)     # output positions
    s1 = min(s_sel, pool)
    tile_floor = vals.reshape(B, nt, m)[:, :, m - 1].amin(1)   # [B]
    if s1 >= tuning.sort_topk_from:
        sv, order = torch.sort(vals, dim=-1, stable=True)
        v1, p = sv[:, :s1], torch.gather(win, 1, order[:, :s1])
    else:
        v1, ci = _topk_min(vals, s1, tuning)
        p = torch.gather(win, 1, ci)
    thresh = tile_floor if s1 >= pool else torch.minimum(v1[:, -1], tile_floor)
    f = _pos_to_window(p, g)
    return _rescan_settle(q32, qn_row, rescan, maskadd, hw, f, k=k, metric=metric, r1=r1,
                          masked=masked, n_live=n_live), thresh


def _rescan_settle(q32, qn_row, rescan, maskadd, hw, f, *, k, metric, r1, masked,
                   n_live=None):
    """Exact f32 rescan of the selected windows ``f`` [B, s1] (pallas_knn_t.py:792-861)
    of the rows ``rescan`` (f32, or a bf16 store's own rows read as f32) through kernel
    B2, then the metric formula, the mask and the final top-k, settled in float64
    (``settle.Settled``, ROADMAP C18: the JAX package's ``lax.top_k`` keeps the f32
    order).  The kernel writes only (dots, sqn) per row, so nothing is chunked but the
    settling.  ``n_live``: rows from it on are zero queries whose windows were selected
    from one zero-query column; they all take row ``n_live``'s windows (the same up to
    ties), and B2 computes that row only (``_gather_score``), so each padded row's ids and
    dots come from the same windows."""
    B, s1 = f.shape
    f = torch.sort(f, dim=1).values.to(torch.int32).contiguous()
    if n_live is not None and n_live + 1 < B:
        f[n_live + 1:] = f[n_live]
    dots, sqn_c = _gather_score(q32, rescan, f, r1=r1, n_live=n_live)
    rws = (f[:, :, None] * r1 + torch.arange(r1, dtype=torch.int32, device=f.device)).reshape(
        B, s1 * r1)
    if metric == "l2":
        dd = torch.clamp_min(qn_row + sqn_c - 2.0 * dots, 0.0)
    elif metric == "ip":
        dd = 1.0 - dots
    else:
        dd = 1.0 - dots * torch.rsqrt(torch.clamp_min(qn_row * sqn_c, 1e-30))
    if masked:
        # a NaN pool entry decodes past the last window (pallas_knn_t.py:265-269): clamp
        # the mask's index as XLA's gather clamps it (the kernel clamps its rows alike)
        dd = dd + maskadd[torch.clamp(rws.long(), 0, maskadd.shape[0] - 1)]
    else:
        dd = torch.where(rws < hw, dd, torch.full_like(dd, float(MASKED)))
    return Settled(dd, rws, q32, rescan, qn_row, sqn_c, kk=min(k, dd.shape[1]), k=k,
                   metric=metric, n_live=n_live)


def _rescan_windows(q32, qn_row, rescan, maskadd, hw, f, *, k, metric, r1, masked,
                    n_live=None):
    """Device ``(best_d, best_i)`` of ``_rescan_settle``, every flagged query settled
    again at the width that covers its band (a host read of the flags)."""
    best_d, best_i, _ = _rescan_settle(q32, qn_row, rescan, maskadd, hw, f, k=k,
                                       metric=metric, r1=r1, masked=masked,
                                       n_live=n_live).resolve()
    return best_d, best_i


# ------------------------------------------------------------------ certificate prep

def _cert_plan(*, certify, light, mixed, lossy_sweep, int8_sweep, use_resid,
               has_sweep_err, has_err1, metric):
    """Static certificate plan (pallas_knn_t.py:911-955): ``(wb_sources, q_tags,
    err_tags)`` — the per-row bound arrays the kernel folds in, the per-query scale of
    each, and the scalar error terms beyond the f32 accumulation slack.

    One intended divergence (ROADMAP C2): the same-dtype sweep (a bf16 mirror of bf16
    rows) ranks with bias and cosine scale rows made from ``sq_norms``, while the rescan
    scores the stored rows with norms of its own summation.  JAX's plan carries only the
    query's rounding, and its store holds the written f32 rows' norms until a compaction,
    so on near-ties whose two norms differ it can certify a wrong set at tier 0
    (tests/test_torch_row_live.py shows both answers).  The port adds the gap: "norm_gap"
    per row, |sqn - |bf16 row|^2| for l2 (scale 1: "one") and ||x| - |bf16 row|| / |x| for
    cosine (scale |q|: "qh"); ip ranks no norm.  The port's store keeps the stored rows'
    norms (ROADMAP C17), so the gap is zero after a write and one rounding after a
    compaction."""
    if not certify:
        return (), (), ()
    if not mixed:
        if lossy_sweep:
            if metric == "cosine":
                return ("norm_gap",), ("qh",), ("qres",)
            if metric == "l2":
                return ("sqn_sqrt", "norm_gap"), ("qres", "one"), ()
            return ("sqn_sqrt",), ("qres",), ()
        return (), (), ()
    if light and (has_err1 or has_sweep_err):
        band = "err1" if has_err1 else "sweep_err"
        if metric == "cosine":
            return (band,), ("qh",), ("qres",)
        return (band, "sqn_sqrt"), ("qh", "qres"), ()
    if use_resid and has_sweep_err:
        return ("sweep_err", "err1"), ("qh", "qres"), ()
    if has_sweep_err:
        return ("sweep_err",), ("qh",), ()
    rel = 2.0 ** -7 if int8_sweep else 2.0 ** -9
    if light:
        rel *= 2.0
    return (), (), (("rel", rel),)


def _row_step(dpad: int) -> int:
    """Rows a pass over stored rows takes at a time: 2^27 elements (2^20 rows at Dp = 128),
    so that a chunk's float64 copy stays at a GiB at any width."""
    return max(1, (1 << 27) // max(dpad, 128))


def search_bytes_bound(cap: int, dpad: int, batch: int, k: int) -> int:
    """Device bytes one certified search over ``cap`` rows of width ``dpad`` may allocate
    beyond the store and the prep its snapshot already holds, at the engine's padded
    ``batch`` and k bucket ``k`` (ROADMAP C16): one ``_row_step`` chunk of the rows in
    float64 (a pass over the stored rows: the norm-gap row's f32 copy and products stay
    within it), the exact scan's tile of 8 * SWEEP_TILE rows widened to f32 with six
    [batch, 8 * SWEEP_TILE] f32 blocks beside it (products, distances, mask, the fold),
    phase 1's window mins three times over (the tile-major output, its [B, P] copy, the
    selection), four f32 arrays of the widest rescan's candidates (8 * max(64, 2k + 48)
    windows of r1 rows) and eight per-row prep vectors."""
    r1 = _pick_r1(batch, cap, k)
    chunk = min(cap, _row_step(dpad)) * dpad * 8
    scan = 8 * SWEEP_TILE * dpad * 4 + 6 * batch * 8 * SWEEP_TILE * 4
    phase1 = 3 * (cap // r1) * batch * 4
    rescan = 4 * batch * min(8 * max(64, 2 * k + 48), cap // r1) * r1 * 4
    return chunk + scan + phase1 + rescan + 8 * cap * 4


def row_sq_norms(rows: torch.Tensor) -> torch.Tensor:
    """Squared norms of stored rows, summed in float64 and rounded to f32, a chunk of
    ``_row_step`` rows at a time: the norms a compaction gives the store (JAX
    namespace.py:786)."""
    return torch.cat([(r.double() * r.double()).sum(-1).float()
                      for r in torch.split(rows, _row_step(rows.shape[1]))])


def _prep_terms(valid, sq_norms, hw, rscale, sweep_err, err1, *, cap, metric, masked,
                use_resid, wb_sources, rscale2=None, int8_sweep=False, rows=None):
    """Query-independent prep (pallas_knn_t.py:958-1012) in store-row order: the bias
    and scale rows, the residual multiplier row, the live-max norm and the
    certificate's per-row bound rows.  ``int8_sweep``: ``rscale`` is the primary dequant
    scale s1, folded into the scale row, and the residual multiplier is s2 / s1
    (``rscale2`` = s2), so that (z1.q + (z2.q)*(s2/s1)) * s1 = s1*z1.q + s2*z2.q.
    ``rows``: the stored rows the rescan scores, for the "norm_gap" bound row."""
    dev = sq_norms.device
    sqn = sq_norms.float()
    if masked:
        maskadd = torch.where(valid, 0.0, float(MASKED)).to(torch.float32)
    else:
        maskadd = torch.where(torch.arange(cap, device=dev) < hw, 0.0,
                              float(MASKED)).to(torch.float32)
    bias = (sqn + maskadd) if metric == "l2" else maskadd
    inv_norm = torch.rsqrt(torch.clamp_min(sqn, 1e-30)) if metric == "cosine" else None
    scale = inv_norm
    if int8_sweep:
        scale = rscale if inv_norm is None else rscale * inv_norm
    rscale_row = None
    if use_resid:
        # s1 == 0 only for all-zero or unwritten rows, whose remainder is zero too
        rscale_row = torch.where(rscale > 0, rscale2 / rscale, 0.0) if int8_sweep else rscale
    live = maskadd < 1.0
    maxd = torch.sqrt(torch.where(live, sqn, torch.zeros_like(sqn)).amax())

    def eb_row(row_norms):
        e = row_norms.float()
        if inv_norm is not None:
            e = e * inv_norm
        return torch.where(live, e, torch.zeros_like(e)).contiguous()

    def norm_gap():   # the rank's norm against the rows' own (see _cert_plan)
        own = []
        for chunk in torch.split(rows, _row_step(rows.shape[1])):
            r = chunk.float()   # one f32 copy a chunk: at most a chunk's float64 bytes
            own.append((r * r).sum(-1))
        own = torch.cat(own)
        if metric == "l2":
            return (sqn - own).abs()
        return (torch.sqrt(sqn) - torch.sqrt(own)).abs()   # times inv_norm in eb_row

    srcs = {"sqn_sqrt": lambda: torch.sqrt(sqn), "sweep_err": lambda: sweep_err,
            "err1": lambda: err1, "norm_gap": norm_gap}
    return {"bias_row": bias.contiguous(), "scale_row": scale, "rscale_row": rscale_row,
            "maxd": maxd, "eb_rows": tuple(eb_row(srcs[s]()) for s in wb_sources)}


def _mixed(mirror_dtype, rescan_dtype) -> bool:
    """A mirror whose rows differ from the rescan's (pallas_knn_t.py:1077): bf16 over f32
    rows, or int8 codes.  A bf16 mirror of a bf16 store (the same-dtype sweep) and the
    f32 mirror are not."""
    return ((mirror_dtype == torch.bfloat16 and rescan_dtype != mirror_dtype)
            or mirror_dtype == torch.int8)


def _plan(*, certify, light, metric, mirror_dtype, rescan_dtype, sweep_err, resid, rscale,
          err1, rscale2):
    """(use_resid, wb_sources, q_tags, err_tags) of a mirror of ``mirror_dtype`` over rows
    of ``rescan_dtype`` (pallas_knn_t.py:1515-1531): a bf16 mirror of f32 rows and an int8
    mirror are mixed and lossy, a bf16 mirror of bf16 rows lossy only, an f32 mirror
    neither; the residual pass needs its arrays, and for an int8 mirror the second scale
    as well.

    The plan is JAX's (``_cert_plan``, with C2's norm-gap row for the same-dtype sweep).
    It bounds the mirror against the rows the rescan scores because the port's store
    computes every mirror, certificate array and norm from the stored rows, at write
    time too: over a bf16 store an int8 mirror's error norms are then the codes' error
    against the stored rows and an f32 mirror is those rows widened, exact.  The JAX
    store computes them from the written f32 values until its first compaction, and
    its plan can then certify a set that is wrong over the stored rows (ROADMAP C17;
    tests/test_torch_bf16_mirrors.py shows both answers)."""
    bf_sweep = mirror_dtype == torch.bfloat16
    int8_sweep = mirror_dtype == torch.int8
    mixed = _mixed(mirror_dtype, rescan_dtype)
    use_resid = (certify and not light and resid is not None and rscale is not None
                 and err1 is not None and (bf_sweep or (int8_sweep and rscale2 is not None)))
    wb, q_tags, err_tags = _cert_plan(
        certify=certify, light=light, mixed=mixed, lossy_sweep=bf_sweep or int8_sweep,
        int8_sweep=int8_sweep, use_resid=use_resid, has_sweep_err=sweep_err is not None,
        has_err1=err1 is not None, metric=metric)
    return use_resid, wb, q_tags, err_tags


def search_prep(mirror, valid, sq_norms, *, metric, live_prefix, certify=True, light=False,
                sweep_err=None, resid=None, rscale=None, err1=None, rscale2=None,
                rescan_dtype=torch.float32):
    """The query-independent prep dict of one search over rows of ``rescan_dtype``
    (pallas_knn_t.py:1377-1427), as ``exact_knn_t`` caches it per snapshot; pass it back
    through ``prep=``."""
    cap = mirror.shape[0]
    use_resid, wb_sources, _, _ = _plan(
        certify=certify, light=light, metric=metric, mirror_dtype=mirror.dtype,
        rescan_dtype=rescan_dtype, sweep_err=sweep_err, resid=resid, rscale=rscale,
        err1=err1, rscale2=rscale2)
    masked = live_prefix is None
    return _prep_terms(valid, sq_norms, cap if masked else live_prefix, rscale, sweep_err,
                       err1, cap=cap, metric=metric, masked=masked, use_resid=use_resid,
                       wb_sources=wb_sources, rscale2=rscale2,
                       int8_sweep=mirror.dtype == torch.int8, rows=mirror)


# ------------------------------------------------------------------ the search

def fetch(*tensors):
    """Bring device tensors to the host in ONE copy: they travel packed as f32 (int32
    bit-cast, float64 as two f32 words, bool as 0/1) and are unpacked to numpy arrays of
    their own dtypes."""
    flat = []
    for t in tensors:
        if t.dtype in (torch.int32, torch.float64):
            flat.append(t.reshape(-1).contiguous().view(torch.float32))
        else:
            flat.append(t.reshape(-1).to(torch.float32))
    host = torch.cat(flat).cpu().numpy()
    out, pos = [], 0
    for t in tensors:
        n = t.numel() * (2 if t.dtype == torch.float64 else 1)
        part = host[pos : pos + n]
        pos += n
        if t.dtype == torch.int32:
            part = part.view(np.int32)
        elif t.dtype == torch.float64:
            part = part.copy().view(np.float64)
        elif t.dtype == torch.bool:
            part = part != 0
        out.append(part.reshape(tuple(t.shape)))
    return out


class SweepResult:
    """Tier-1 result of one exact search, still on the device.

    ``dist``/``idx`` [B, k], the per-query proof ``okq`` [B] bool (None when no proof is
    needed: margin mode, the row-major path, or the shape gate sent the search to the
    scan, ``tier`` -1), and ROADMAP C18's ``need`` [B] int32 (None where the path settled
    its flags itself): nonzero where the float64 settle left out a candidate within the
    f32 band of the k-th.  ``key`` [B, k]: the float64 distances the list is ordered by
    (the sharded merge orders by them).  A caller brings ``parts()`` down in one copy and
    calls ``finish``, which escalates a failed proof and settles flagged queries wider,
    each further copy through the caller's ``fetch`` (so the caller can count them)."""

    def __init__(self, dist, idx, okq, tier, escalate=None, *, settled=None, key=None,
                 need=None):
        self.dist, self.idx, self.okq, self.tier = dist, idx, okq, tier
        self._escalate = escalate
        self.settled = settled
        self.key = settled.key if settled is not None else key
        self.need = settled.need if settled is not None else need

    def parts(self):
        """The tensors of the caller's one copy: dist, idx, and okq and need if present."""
        return tuple(t for t in (self.dist, self.idx, self.okq, self.need) if t is not None)

    def finish(self, host, fetch_: Callable = fetch, settle_fetch: Callable = None):
        """Host ``(dist, idx, tier)`` from the fetched ``parts()``: the escalation where a
        proof failed, each copy through ``fetch_``; else every flagged query settled again
        at its width, each copy through ``settle_fetch`` (default ``fetch_``), the tier
        kept: one copy, two on the sharded merge (the shards' lists, then the settle)."""
        dist, idx, rest = host[0], host[1], list(host[2:])
        okq = rest.pop(0) if self.okq is not None else None
        need = rest.pop(0) if self.need is not None else None
        if okq is not None and not okq.all():
            return self._escalate(okq, need, fetch_, False)[:3]
        if need is None or not need.any():
            return dist, idx, self.tier
        settle_fetch = settle_fetch or fetch_
        if self.settled is None:
            return self._escalate(okq, need, settle_fetch, False)[:3]
        rows = np.arange(len(need))
        dist, idx = widen_host([dist, idx], need, [(self.settled, rows, rows)], settle_fetch)
        return dist, idx, self.tier

    def escalate(self, okq_host: np.ndarray, fetch: Callable = fetch, keys: bool = False,
                 need_host=None):
        """Host ``(dist, idx, tier)`` after a failed proof, plus the float64 keys with
        ``keys``; the escalation settles its own flags."""
        out = self._escalate(okq_host, need_host, fetch, keys)
        return out if keys else out[:3]

    def resolve(self):
        """Device ``(dist, idx, tier)``: the proof and the flags read here, escalation
        or the wider settle if they ask for it."""
        small = [t for t in (self.okq, self.need) if t is not None]
        if not small:
            return self.dist, self.idx, self.tier
        host = fetch(*small)
        okq = host[0] if self.okq is not None else None
        need = host[-1] if self.need is not None else None
        if (okq is None or okq.all()) and (need is None or not need.any()):
            return self.dist, self.idx, self.tier
        d, i, tier = self.finish(fetch(self.dist, self.idx) + host)
        dev = self.dist.device
        return torch.from_numpy(d).to(dev), torch.from_numpy(i).to(dev), tier


def _rank_terms(metric: str, kth, kth_rank, qn, ql, maxd, dp: int):
    """ROADMAP C19: the f32 terms of ``_certify``'s inequality beyond phase 1's sums and
    the mirror's, in rank units, per query: ``kth`` [B] the settled k-th (fl32 of its
    float64 distance: u |kth| from it), ``kth_rank`` its rank as the check computes it in
    f32 (one rounding of the subtraction, and for cosine of the product), ``qn`` [B] the
    f32 |q|^2 (within g of it: l2 adds it, cosine's ``ql`` = sqrt(qn) scales by it),
    ``maxd`` the largest live row norm (the bias row's f32 |x|^2 within g m^2 at l2,
    cosine's scale row rsqrt(|x|^2) within g + 2^-21 of 1/|x|) and the kernel's epilogue
    adds, 2^-21 of their terms' magnitude (l2 m^2 + 2 |q| m, ip |q| maxd, cosine |q|).
    At l2 m is the smaller of maxd and |q| + sqrt(d_k): a row of larger norm has
    |x|^2 - 2 q.x > d_k - |q|^2, so it cannot beat the k-th whatever its rounding.
    g = (Dp + 4) u / (1 - (Dp + 4) u), u = 2^-24, as ``settle.f32_band``'s: the same
    derivation as the row-major proof's (``fused_knn`` module docstring).  For a zero
    query at ip and cosine every product is 0 and every value exact: no term (the
    engine's padded rows are zero queries, and their proofs count, as JAX's do)."""
    g = (dp + 4) * U / (1 - (dp + 4) * U)
    e = 2.0 ** -21
    if metric == "l2":
        # a row of norm above |q| + sqrt(d_k) ranks above the k-th whatever its rounding:
        # the bias row's and the adds' terms take the smaller of that and maxd
        m = torch.minimum(maxd * (1 + g), ql * (1 + g) + torch.sqrt(kth.clamp_min(0) * (1 + U)))
        return (U * kth.abs() + g * qn + 2 * U * kth_rank.abs() + (g + e) * m * m
                + 2 * e * ql * m)
    if metric == "ip":   # a zero query's ranks and k-th are exact (0 and 1): no term
        return (ql > 0) * (U * kth.abs() + 2 * U * kth_rank.abs() + e * ql * maxd)
    return ql * (U * kth.abs() + (g + 4 * U) * (kth - 1.0).abs() + g + 2 * e)


def _certify(kth, thresh, err, qn, ql, maxd, metric: str, dp: int):
    """The per-query proof of the certified sweep (pallas_knn_t.py's ``check_exact``, with
    ROADMAP C19's terms): every window not rescanned ranks at least ``thresh - err``, at
    or above the rank of the settled k-th ``kth`` [B] (l2 kth - qn, ip kth - 1, cosine
    (kth - 1) |q|, in f32 as JAX computes it).  ``err`` [B]: phase 1's sums and the
    mirror's terms; ``_rank_terms`` adds the rest, the sum widened by 2^-20 for its own
    f32 arithmetic, and the comparison runs in float64.  A k-th that is a masked slot is
    proven only where every window was rescanned (thresh +inf)."""
    if metric == "l2":
        kth_rank = kth - qn
    elif metric == "ip":
        kth_rank = kth - 1.0
    else:
        kth_rank = (kth - 1.0) * ql
    e = (err + _rank_terms(metric, kth, kth_rank, qn, ql, maxd, dp)) * (1 + 2.0 ** -20)
    return torch.where(kth < float(MASKED) / 2,
                       thresh.double() - e.double() >= kth_rank.double(), torch.isinf(thresh))


def _ladder(st1, okq, select_wide, prove, exact_fallback, *, tier2_exists, contain):
    """The escalation after a failed per-query proof, the certified sweep's and the
    row-major path's (ROADMAP C20): ``escalate(okq_host, need_host, fetch_, keys)`` for a
    ``SweepResult`` whose tier-1 ``Settled`` is ``st1`` and device proof ``okq``.  Without
    a tier 2 (``tier2_exists`` False), the exact scan ``exact_fallback(fetch_, keys)``.
    Where ``contain`` and at most FQ_CONTAIN queries failed, those (stable order, padded
    with passing ones, as ``lax.top_k`` pads) are selected again at the tier-2 width,
    ``select_wide(rows)``, and proven again together, ``prove(dist, thresh, rows)``; the
    rest keep tier 1.  Else the whole batch is, ``select_wide(None)``.  A failed re-proof
    goes to the scan.  Returns host ``(dist, idx, tier, key or None)``: each copy through
    ``fetch_``, the serving tier's flagged queries settled wider."""
    d1, i1 = st1.dist, st1.idx

    def escalate(okq_host, _need_host, fetch_, keys):
        if not tier2_exists:
            return exact_fallback(fetch_, keys)
        n = okq_host.shape[0]
        extra = lambda key: (key,) if keys else ()        # noqa: E731
        if contain and int((~okq_host).sum()) <= FQ_CONTAIN:
            fidx = torch.sort((~okq).to(torch.float32), descending=True,
                              stable=True).indices[:FQ_CONTAIN]
            st_f, th_f = select_wide(fidx)
            ok_f = prove(st_f.dist, th_f, fidx).all()
            host = fetch_(d1.index_copy(0, fidx, st_f.dist), i1.index_copy(0, fidx, st_f.idx),
                          ok_f, st1.need.index_copy(0, fidx, st_f.need),
                          *extra(st1.key.index_copy(0, fidx, st_f.key)))
            fx = fidx.cpu().numpy()
            kept = np.setdiff1d(np.arange(n), fx)
            groups = [(st1, kept, kept), (st_f, fx, np.arange(len(fx)))]
        else:
            st2, th2 = select_wide(None)
            host = fetch_(st2.dist, st2.idx, prove(st2.dist, th2, None).all(), st2.need,
                          *extra(st2.key))
            groups = [(st2, np.arange(n), np.arange(n))]
        if not bool(host[2]):
            return exact_fallback(fetch_, keys)
        out = widen_host([host[0], host[1]] + host[4:], host[3], groups, fetch_)
        return out[0], out[1], 1, (out[2] if keys else None)

    return escalate


def _fold_query(q32, metric, light, mirror_dtype=torch.bfloat16, mixed=True):
    """The kernel's query operands (pallas_knn_t.py:1066-1087): the metric factor folded
    in (l2 ranks by -2q.x, ip and cosine by -q.x), rounded to bf16 as ``qh`` against a
    bf16 or int8 mirror and kept f32 against an f32 one, and the rounding residual
    ``qres_f32``; ``qres`` is its compensation operand in qh's type, given only to a
    mixed lossy mirror's heavy program (None for the light program, the same-dtype sweep
    and the f32 mirror)."""
    q_fold = -2.0 * q32 if metric == "l2" else -q32
    lossy = mirror_dtype != torch.float32
    qh = q_fold.to(torch.bfloat16 if lossy else torch.float32)
    qres_f32 = q_fold - qh.float()
    return qh, (qres_f32.to(qh.dtype) if lossy and mixed and not light else None), qres_f32


def _fused_t(q, mirror, rescan, valid, sq_norms, hw, resid, prep, *, k, metric, r1,
             masked, certify, light, use_resid, q_tags, err_tags, tuning, n_live=None):
    """Phase 1, tier-1 selection and rescan, and the per-query certificate
    (pallas_knn_t._fused_t, :1022-1347), with the escalation packed into the result.
    ``n_live``: rows from it on are the engine's zero padding; phase 1 computes only the
    live columns and takes the padding's from the zero-query outputs cached in ``prep``,
    and the rescan of tier 1 and of the widened (non-contained) tier 2 computes the live
    rows and the first padded row, whose outputs the other padded rows take (their window
    mins are one column's copies, so they select the same windows).  Everything else sees
    the padded batch with the values a full computation gives, as the JAX package does:
    the proof ``okq``, ``thresh``, ``best_d``, the tier-2 gate and the contained
    escalation, which re-proves a subset of the rows and so computes all of them."""
    cap, Dp = mirror.shape
    B = q.shape[0]
    g = R1MAX // r1
    # each phase is a span under the caller's ``knn_kernel``; escalation runs later,
    # under ``knn_finish``
    with trace_span("sweep.phase1"):
        q32 = q.float()
        qn_row = (q32 * q32).sum(-1)
        # compensated query: qh + qres represents the folded query to ~2^-18; light skips it
        qh, qres, qres_f32 = _fold_query(q32, metric, light, mirror.dtype,
                                         _mixed(mirror.dtype, rescan.dtype))

        P_all = cap // r1
        if not certify:
            s1_w = min(2 * k, k + 16)
        elif any(isinstance(t, tuple) for t in err_tags):
            s1_w = max(64, 2 * k + 48)
        else:
            s1_w = min(2 * k, k + 16 + k // 8)
        s1_w = min(s1_w, P_all)

        # the per-tile top-m pool (pallas_knn_t.py:1112-1165): m covers 4x the tier-1 width
        # per tile; k <= 32 at r1 = 32 keeps the block-min selection (JAX's MLVDB_TOPM_BM=0)
        m_base = 8 if k <= 128 else 16
        nt_all = cap // SWEEP_TILE
        m_need = -(-4 * s1_w // max(nt_all, 1))
        m_top = max(m_base, -(-m_need // 2) * 2)
        out_w_all = g * WLANE
        bm_eligible = k <= 32 and r1 == R1MAX and P_all % WLANE == 0 and P_all // WLANE > 1
        use_topm = (certify and tuning.topm_enable and not bm_eligible
                    and P_all % WLANE == 0 and nt_all > 1 and m_top * g <= 32
                    and nt_all * m_top >= 4 * s1_w and out_w_all * out_w_all <= (1 << 24))
        # the JAX package's layout choice; the port always writes tile-major, which the
        # selection indexes as JAX's [B, P] form, so it decides only the gates below (probe
        # B6 timed both forms of the kernel: PERF.md)
        transposed = (k <= 128 or use_topm) and P_all % WLANE == 0 and P_all // WLANE > 1
        use_topm = use_topm and transposed
        r2 = WLANE if (transposed and k <= 32) else R2
        emit_bm = transposed and r2 == WLANE and g == 1 and not use_topm
        s2_w = min(8 * s1_w, P_all)
        tier2_exists = s2_w > s1_w and B * s2_w * r1 <= cap
        # the pool serves tier 1 and no tier 2 would read the window mins: pool only
        skip_wm = use_topm and not tier2_exists

        q_l2 = torch.sqrt(qn_row)
        qh_l2 = q_l2 * (2.0 if metric == "l2" else 1.0)
        maxd = prep["maxd"]
        slack = (Dp * 2.0 ** -22) * qh_l2 * (1.0 if metric == "cosine" else maxd)
        qres_l2 = torch.sqrt((qres_f32 * qres_f32).sum(-1))
        q_scales = {"qh": qh_l2, "qres": qres_l2, "one": torch.ones_like(qh_l2)}
        eb_rows = tuple(prep["eb_rows"])
        qe = torch.stack([q_scales[t] for t in q_tags], dim=1).contiguous() if eb_rows else None
        err = slack
        for t in err_tags:
            if t == "qres":
                err = err + qres_l2
            else:
                err = err + t[1] * qh_l2 * (1.0 if metric == "cosine" else maxd)

        def check_exact(best_d, thresh, sel=None):
            """Per query: every window not rescanned ranks at least ``thresh - err``, above
            the k-th's rank (``_certify``; ``err``: phase 1's sums and the mirror's terms)."""
            if sel is None:
                return _certify(best_d[:, k - 1], thresh, err, qn_row, q_l2, maxd, metric, Dp)
            return _certify(best_d[:, k - 1], thresh, err[sel], qn_row[sel], q_l2[sel], maxd,
                            metric, Dp)

        wmin_t, bm, topm = _window_mins_t(
            qh, qres, mirror, resid if use_resid else None, prep["rscale_row"],
            prep["scale_row"], prep["bias_row"], r1=r1, emit_block_mins=emit_bm,
            emit_topm=m_top if use_topm else 0, skip_wm=skip_wm, qe=qe, eb_rows=eb_rows,
            n_live=n_live,
            zero_cache=None if n_live is None else prep.setdefault("zero_query", {}),
        )
    with trace_span("sweep.rescan"):
        wmin2_pre = None if bm is None else bm.T.contiguous()    # [B, nt] block mins
        maskadd = torch.where(valid, 0.0, float(MASKED)).to(torch.float32) if masked else None
        qn_col = qn_row[:, None]

        def select(s_sel, sub=slice(None), live=None):
            """Selection and rescan at width s_sel for the queries ``sub`` (``live``: the
            rescan's live count, for the whole batch only): ``(Settled, thresh)``."""
            return _select_and_rescan(
                q32[sub], qn_col[sub], rescan, maskadd, hw, wmin_t[:, sub, :], k=k,
                metric=metric, r1=r1, masked=masked, s_sel=s_sel, r2=r2, spec_l2=certify,
                wmin2=None if wmin2_pre is None else wmin2_pre[sub], tuning=tuning,
                n_live=live)

        if use_topm:
            # tier 1 from the pool: a tile hiding more than m candidates lowers thresh
            st1, th1 = _select_topm_and_rescan(
                q32, qn_col, rescan, maskadd, hw, topm, k=k, metric=metric, r1=r1,
                masked=masked, s_sel=s1_w, m=m_top, tuning=tuning, n_live=n_live)
        else:
            st1, th1 = select(s1_w, live=n_live)
        d1, i1 = st1.dist, st1.idx
    with trace_span("sweep.proof"):
        if not certify:
            return SweepResult(d1, i1, None, 0, settled=st1)
        okq = check_exact(d1, th1)                            # [B] per-query proof

        def exact_fallback(fetch_, keys):
            # the scan scores the stored rows as the rescan does, with the f32 query (over a
            # bf16 store ROADMAP C15: the JAX package ranks bf16(q) there); it settles its
            # own flags
            d, i, key = exact_knn(q32, rescan, valid, sq_norms.float(), k=k, metric=metric,
                                  db_tile=8 * SWEEP_TILE, round_query=False, with_key=True,
                                  n_live=n_live)
            if keys:
                d, i, key = fetch_(d, i, key)
                return d, i, 2, key
            d, i = fetch_(d, i)
            return d, i, 2, None

        def select_wide(sub):   # tier 2's width: the whole batch (sub None) or the rows sub
            return select(s2_w, live=n_live) if sub is None else select(s2_w, sub=sub)

        # (skip_wm keeps no window mins for a tier 2: its failed proof goes to the scan)
        escalate = _ladder(st1, okq, select_wide, check_exact, exact_fallback,
                           tier2_exists=tier2_exists,
                           contain=tuning.contain and B > FQ_CONTAIN and not skip_wm)
        return SweepResult(d1, i1, okq, 0, escalate, settled=st1)


def exact_knn_t(q, mirror, rescan_data, valid, sq_norms, *, k, metric, live_prefix=None,
                r1_override=None, sweep_err=None, resid=None, rscale=None, err1=None,
                rscale2=None, certify=True, report_tier=False, light=False, prep_cache=None,
                prep=None, tuning=DEFAULT_TUNING, defer=False, n_live=None):
    """Certified sweep exact k-NN (pallas_knn_t.exact_knn_pallas_t); same results
    contract as ops.topk.exact_knn.

    ``mirror`` [cap, Dp] row-major: bf16, int8 codes or f32; ``rescan_data`` [cap, Dp]
    f32, or a bf16 store's rows (then the mirror is those rows: the same-dtype sweep).
    ``sweep_err``, ``resid``/``rscale``/``err1``: the store's certificate arrays (see
    ``quantize_resid_rows``); for an int8 mirror ``rscale`` is its dequant scale
    s1, and ``resid``/``rscale2`` the second stream's codes and scale s2 (see
    ``quantize_int8_resid_rows``).  ``light``: the single-pass program.  ``prep_cache``: the
    snapshot's dict of query-independent prep.  ``report_tier`` adds the tier that served
    the batch: 0 certified tier 1 selection, 1 contained or widened selection, 2 exact
    scan, -1 the shape gate sent the search to the scan (no certificate ran).
    ``defer``: return the device-side ``SweepResult`` instead (see its docstring).
    ``n_live``: the caller's batch before it padded ``q`` with zero rows (None: every row
    is live); phase 1 then computes only the live query columns (``_window_mins_t``)."""
    cap, Dp = mirror.shape
    B = q.shape[0]
    qt_w = min(Q_TILE, B)
    r1 = r1_override or _pick_r1(B, cap, k)
    if (cap < 2 * SWEEP_TILE or cap % SWEEP_TILE != 0 or B % qt_w != 0 or Dp % 128 != 0
            or k * r1 > cap or r1 not in (1, 2, 4, 8, 16, 32)
            or (mirror.dtype == torch.int8 and rscale is None)):  # codes need their scales
        d, i, key = exact_knn(q, rescan_data, valid, sq_norms, k=k, metric=metric,
                              db_tile=SWEEP_TILE, with_key=True, n_live=n_live)
        res = SweepResult(d, i, None, -1, key=key)
    else:
        masked = live_prefix is None
        hw = cap if masked else int(live_prefix)
        use_resid, wb_sources, q_tags, err_tags = _plan(
            certify=certify, light=light, metric=metric, mirror_dtype=mirror.dtype,
            rescan_dtype=rescan_data.dtype, sweep_err=sweep_err, resid=resid,
            rscale=rscale, err1=err1, rscale2=rscale2)
        if prep is None:
            key = (metric, -1 if masked else hw, masked, certify, light, use_resid,
                   wb_sources, str(mirror.dtype))
            prep = prep_cache.get(key) if prep_cache is not None else None
            if prep is None:
                prep = _prep_terms(
                    valid, sq_norms, hw, rscale, sweep_err, err1, cap=cap, metric=metric,
                    masked=masked, use_resid=use_resid, wb_sources=wb_sources,
                    rscale2=rscale2, int8_sweep=mirror.dtype == torch.int8,
                    rows=rescan_data)
                if prep_cache is not None:
                    prep_cache[key] = prep  # GIL-atomic; a racing reader recomputes
        res = _fused_t(q, mirror, rescan_data, valid, sq_norms, hw, resid, prep, k=k,
                       metric=metric, r1=r1, masked=masked, certify=certify, light=light,
                       use_resid=use_resid, q_tags=q_tags, err_tags=err_tags,
                       tuning=tuning, n_live=n_live)
    if defer:
        return res
    d, i, tier = res.resolve()
    return (d, i, tier) if report_tier else (d, i)
