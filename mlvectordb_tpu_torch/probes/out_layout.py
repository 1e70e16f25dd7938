"""Probe B6: does the sweep kernel's output layout change its speed?  The counterpart of
``benchmarks/probe_out3d.py``.

Both kernels are the one-pass window min of kernel B1 (``csrc/sweep_min.cu``) over a
bf16 mirror [N, D] (row-major, as the store keeps it), against the queries
``qh = bf16(-q)`` with a zero bias row, as the TPU probe runs them, at r1 = 32 (g = 1,
the probe's shape) or any r1 (r1 = 4, g = 8: the k=1000 program's, for which the JAX
package takes the non-transposed form):

  "2d" ``out_2d`` — the JAX package's non-transposed output ``[B, nt*g*128]``
       (``transposed=False``, pallas_knn_t.py:453-457): each tile writes B rows of
       g*512 bytes, P*4 bytes apart;
  "3d" ``out_3d`` — tile-major ``[nt, B, g*128]``, what the search uses: each tile's
       mins are one contiguous block.

Both carry the same positions, so ``out_2d`` equals ``out_3d`` permuted, bit for bit.  Each
wrapper launches kernel B1 for a CUDA tensor (counted on ``_window_mins_t.launches_bp``
for "2d", ``launches`` for both) and runs its plain version for a CPU tensor.  The probe
reports GB/s as ``(N*D*2 + B*(N/r1)*4) / t``, the TPU probe's count at r1 = 32
(probe_out3d.py:112).  ``chip_smoke.py`` phase 13 runs it on the card.
"""

from __future__ import annotations

import torch

from ..ops.fused_knn_t import R1MAX, WLANE, _window_mins_t, _window_mins_t_ref


def operands(rows: torch.Tensor, q: torch.Tensor):
    """(qh [B, D] bf16, the bf16 mirror [N, D], a zero bias row [N]) of the probe."""
    mirror = rows.to(torch.bfloat16)
    bias = torch.zeros(mirror.shape[0], dtype=torch.float32, device=mirror.device)
    return (-q.float()).to(torch.bfloat16), mirror, bias


def out_2d(qh, mirror, bias, r1=R1MAX):
    """[B, nt*g*128] window mins (the non-transposed form)."""
    return _window_mins_t(qh, None, mirror, None, None, None, bias, r1=r1,
                          transposed=False)[0]


def out_3d(qh, mirror, bias, r1=R1MAX):
    """[nt, B, g*128] window mins (tile-major)."""
    return _window_mins_t(qh, None, mirror, None, None, None, bias, r1=r1)[0]


def out_2d_ref(qh, mirror, bias, r1=R1MAX):
    return _window_mins_t_ref(qh, None, mirror, None, None, None, bias, r1=r1,
                              transposed=False)[0]


def out_3d_ref(qh, mirror, bias, r1=R1MAX):
    return _window_mins_t_ref(qh, None, mirror, None, None, None, bias, r1=r1)[0]


def as_tile_major(wmin_2d: torch.Tensor, r1: int = R1MAX) -> torch.Tensor:
    """[B, nt*g*128] -> [nt, B, g*128]: the positions the two forms share."""
    b = wmin_2d.shape[0]
    return wmin_2d.reshape(b, -1, (R1MAX // r1) * WLANE).permute(1, 0, 2)


def gbs(n: int, d: int, b: int, ms: float, r1: int = R1MAX) -> float:
    """GB/s as the TPU probe counts them: the bf16 mirror read once, the f32 mins written."""
    return (n * d * 2 + b * (n // r1) * 4) / (ms * 1e-3) / 1e9

