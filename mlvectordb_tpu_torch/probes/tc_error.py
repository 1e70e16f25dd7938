"""The sweep kernel's accumulation error on the tensor cores, against float64.

``dots`` launches kernel B1/B3 with one-row windows and no row terms (rank = qh . x), so
its window mins are the dots themselves, and puts them back in row order.
``max_rel_err`` is the largest |dot - float64 dot| / (|qh| |x|) over the rows and
queries.  The kernel's note (``csrc/sweep_min.cu``) bounds it by Dp * (1 + 1/s) * 2^-23
under the tensor cores' align-and-truncate model (s products per k-group), and
``chip_smoke.py`` holds the measured maxima to Dp * 2^-23, which keeps the rescan's
Dp * 2^-24 inside the certificate's Dp * 2^-22 slack.  ``hard_rows`` and
``hard_queries`` make inputs that stress that model: exponents spread over 2^-20 .. 2^10
within a row, and signs that cancel within a k-group and across the two halves of a row;
``int8_extremes`` gives codes of +-127.  Each operand is exact in bf16, so float64 gives
the exact dots.  The same two functions take an f32 query and an f32 mirror (kernel B3's
six passes of the three-way bf16 split, bounded in the kernel's note by about
(1.048 * Dp * (1 + 1/s) + 1.52) * 2^-23), on ``hard_rows_f32`` / ``hard_queries_f32``
below or gaussian f32 values; float64 gives the exact dots of f32 values too.

``b4_dots`` does the same for the row-major kernel B4 (``csrc/window_min.cu``) over f32 rows
(the three-way bf16 split, six passes) or bf16 rows (one pass): ip with one-row windows
and every row live, so each window min is 1 - dot, rounded once in f32; the dot comes back
as 1 - d in float64, within 2^-24 * (1 + |dot|) of the kernel's.  ``b4_max_rel_err`` is the
largest |dot - float64 dot| / (|q| |x|) over the rows and queries; with |q||x| >= 2^8, as
the inputs below give, that rounding adds under 2^-23 to it.  ``hard_rows_f32`` and
``hard_queries_f32`` are ``hard_rows`` / ``hard_queries`` with full 24-bit significands
(f32, not bf16), so every part of the split carries bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fused_knn import DB_TILE, _window_mins_fast
from ..ops.fused_knn_t import R1MAX, SWEEP_TILE, WLANE, _window_mins_t


def dots(qh: torch.Tensor, mirror: torch.Tensor) -> torch.Tensor:
    """[N, B] f32 dots of qh [B, D] with the mirror [N, D] (bf16 qh against bf16 or int8
    codes, f32 qh against f32), as the kernel sums them: one-row windows (r1 = 1), no
    scale, bias or bound rows."""
    out = _window_mins_t(qh, None, mirror, None, None, None, None, r1=1)[0]  # [nt, B, 4096]
    nt, b, _ = out.shape
    # window (row) j*32 + a of a tile sits at position a*128 + j
    return out.reshape(nt, b, R1MAX, WLANE).permute(0, 3, 2, 1).reshape(nt * SWEEP_TILE, b)


def max_rel_err(qh: torch.Tensor, mirror: torch.Tensor, chunk: int = 1 << 20) -> float:
    """max |kernel dot - float64 dot| / (|qh| |x|) over every row and query, ``chunk``
    rows (a multiple of 4096) at a time."""
    q64 = qh.double()
    qn = torch.linalg.vector_norm(q64, dim=1)
    worst = 0.0
    for lo in range(0, mirror.shape[0], chunk):
        m = mirror[lo:lo + chunk]
        x64 = m.double()
        want = x64 @ q64.T
        got = dots(qh, m).double()
        denom = torch.linalg.vector_norm(x64, dim=1)[:, None] * qn[None, :]
        worst = max(worst, float(((got - want).abs() / denom).max()))
        del x64, want, got, denom
    return worst


def hard_rows(rng: np.random.Generator, n: int, d: int) -> torch.Tensor:
    """[n, d] bf16 rows: magnitudes 2^-20 .. 2^10 mixed within each row, random signs;
    every other row's second half the negated first half, and every fourth row's odd
    dimensions the negated even ones (against ``hard_queries``' matching halves and
    pairs, those terms cancel exactly)."""
    x = (rng.choice([-1.0, 1.0], (n, d)) * rng.uniform(1.0, 2.0, (n, d))
         * np.exp2(rng.integers(-20, 11, (n, d))))
    x[::2, d // 2:] = -x[::2, : d // 2]
    x[1::4, 1::2] = -x[1::4, 0::2]
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def hard_queries(rng: np.random.Generator, b: int, d: int) -> torch.Tensor:
    """[b, d] bf16 queries, magnitudes 2^-4 .. 2^4; half of them repeat each value in an
    adjacent pair and the first half of the row in the second, so the cancelling rows of
    ``hard_rows`` sum large terms to nothing."""
    q = (rng.choice([-1.0, 1.0], (b, d)) * rng.uniform(1.0, 2.0, (b, d))
         * np.exp2(rng.integers(-4, 5, (b, d))))
    quarter = q[: b // 2, : d // 4]
    q[: b // 2] = np.tile(np.repeat(quarter, 2, axis=1), (1, 2))
    return torch.from_numpy(q.astype(np.float32)).to(torch.bfloat16)


def int8_extremes(rng: np.random.Generator, n: int, d: int) -> torch.Tensor:
    """[n, d] int8 codes of +-127 with random signs."""
    return torch.from_numpy((rng.choice([-127, 127], (n, d))).astype(np.int8))


def b4_dots(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[N, B] float64 dots of the f32 queries q [B, D] (rounded to bf16 first for bf16
    rows, as the engine rounds them) with rows [N, D] (f32 or bf16), as kernel B4 sums
    them: ip, one-row windows, every row live; dot = 1 - window min."""
    qt = q.T.to(rows.dtype).float().contiguous()
    qn = (qt * qt).sum(0)[None, :].contiguous()
    d = _window_mins_fast(rows, qt, qn, rows.shape[0], metric="ip", db_tile=DB_TILE, r1=1)
    return 1.0 - d.double()


def b4_max_rel_err(q: torch.Tensor, rows: torch.Tensor, chunk: int = 1 << 20) -> float:
    """max |B4 dot - float64 dot| / (|q| |x|) over every row and query, ``chunk`` rows (a
    multiple of 4096) at a time; the query as B4 multiplies it (bf16-rounded for bf16 rows)."""
    q64 = q.to(rows.dtype).double()
    qn = torch.linalg.vector_norm(q64, dim=1)
    worst = 0.0
    for lo in range(0, rows.shape[0], chunk):
        x64 = rows[lo:lo + chunk].double()
        want = x64 @ q64.T
        got = b4_dots(q, rows[lo:lo + chunk])
        denom = torch.linalg.vector_norm(x64, dim=1)[:, None] * qn[None, :]
        worst = max(worst, float(((got - want).abs() / denom).max()))
        del x64, want, got, denom
    return worst


def hard_rows_f32(rng: np.random.Generator, n: int, d: int) -> torch.Tensor:
    """``hard_rows`` in f32: magnitudes 2^-20 .. 2^10 with full significands, random signs,
    the same cancelling halves and pairs."""
    x = (rng.choice([-1.0, 1.0], (n, d)) * rng.uniform(1.0, 2.0, (n, d))
         * np.exp2(rng.integers(-20, 11, (n, d))))
    x[::2, d // 2:] = -x[::2, : d // 2]
    x[1::4, 1::2] = -x[1::4, 0::2]
    return torch.from_numpy(x.astype(np.float32))


def hard_queries_f32(rng: np.random.Generator, b: int, d: int) -> torch.Tensor:
    """``hard_queries`` in f32 (magnitudes 2^-4 .. 2^4, full significands)."""
    q = (rng.choice([-1.0, 1.0], (b, d)) * rng.uniform(1.0, 2.0, (b, d))
         * np.exp2(rng.integers(-4, 5, (b, d))))
    quarter = q[: b // 2, : d // 4]
    q[: b // 2] = np.tile(np.repeat(quarter, 2, axis=1), (1, 2))
    return torch.from_numpy(q.astype(np.float32))
