"""Probe B7: is the int8 sweep bound by its convert or by its memory traffic?  The
counterpart of ``benchmarks/probe_int8_mxu.py``.

Three kernels over the same int8 mirror codes [N, D] (row-major, as the store keeps
them) and B queries, each writing one value per window of 32 consecutive rows,
tile-major [N / 4096, B, 128] as the sweep kernel does at r1 = 32:

  kA ``convert_mma_min`` — the codes converted to bf16 in registers against bf16
     queries, bf16 ``mma.sync`` with f32 sums, the window min: kernel B3's int8 one-pass
     route (``csrc/sweep_min.cu``), called without scale or bias rows.
  kB ``mma_min`` — int8 codes x int8 queries -> int32 dots on the tensor cores
     (``mma.sync`` m16n8k32, ``csrc/int8_probe.cu``), the int32 window min.  The
     queries are quantized as the TPU probe quantizes them (``quantize_queries``).  A
     measurement, not a serving route: an int8-quantized query is outside the
     certificate.
  kC ``stream_sum`` — every code of the window summed (int32), written for every query:
     the memory floor (``csrc/int8_probe.cu``).

Each wrapper launches its kernel for a CUDA tensor and runs its plain torch version
(``*_ref``) for a CPU tensor.  kB and kC are exact integer results, so kernel and plain
version are equal on the card; kA is B3 and compares as B3 does (within its phase-1
budget, ``fused_knn_t._phase1_budget``).
"""

from __future__ import annotations

import torch

from ..ops import _kernels
from ..ops.distances import require_f32_matmul
from ..ops.fused_knn_t import R1MAX, SWEEP_TILE, WLANE, _window_mins_t, _window_mins_t_ref

QB = 64  # queries per mma_min block: the batch must be a multiple


def quantize_queries(q: torch.Tensor) -> torch.Tensor:
    """int8 queries as the TPU probe makes them (probe_int8_mxu.py:93):
    clip(round(16 q), -127, 127)."""
    return torch.clamp(torch.round(q.float() * 16.0), -127, 127).to(torch.int8)


def convert_mma_min(qh: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """kA: [nt, B, 128] f32 window mins of qh [B, D] bf16 . codes [N, D] int8 (kernel B3,
    one pass on the tensor cores, no scale or bias rows; its launches count on
    ``_window_mins_t``)."""
    return _window_mins_t(qh, None, codes, None, None, None, None, r1=R1MAX)[0]


def convert_mma_min_ref(qh: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    return _window_mins_t_ref(qh, None, codes, None, None, None, None, r1=R1MAX)[0]


def _tile_major(per_window: torch.Tensor, nt: int) -> torch.Tensor:
    """[N / 32, B] per-window values -> tile-major [nt, B, 128]."""
    return per_window.reshape(nt, WLANE, -1).permute(0, 2, 1).contiguous()


def mma_min_ref(q8: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Plain version of kB: the int8 dots are integers below 2^24 in magnitude (at most
    D * 127^2), so an f32 product without TF32 gives them exactly."""
    require_f32_matmul()
    n = codes.shape[0]
    dots = codes.float() @ q8.float().T                               # [N, B]
    mins = dots.reshape(n // R1MAX, R1MAX, -1).amin(1).to(torch.int32)
    return _tile_major(mins, n // SWEEP_TILE)


def stream_sum_ref(codes: torch.Tensor, batch: int) -> torch.Tensor:
    """Plain version of kC: each window's codes summed, the same for every query."""
    n = codes.shape[0]
    sums = codes.reshape(n // R1MAX, -1).sum(-1, dtype=torch.int32)
    return _tile_major(sums[:, None].expand(-1, batch), n // SWEEP_TILE)


def _check(codes, q8=None, batch=None):
    n, d = codes.shape
    for name, t in (("codes", codes), ("q8", q8)):
        if t is not None and (t.dtype != torch.int8 or not t.is_contiguous()
                              or t.device != codes.device):
            raise ValueError(f"{name} must be a contiguous int8 tensor on {codes.device}")
    b = batch if q8 is None else q8.shape[0]
    if (n % SWEEP_TILE or n == 0 or d % 32 or b <= 0 or (q8 is not None and (
            b % QB or q8.shape[1] != d))):
        raise ValueError(f"the probe needs N % {SWEEP_TILE} == 0, D % 32 == 0 and, for "
                         f"mma_min, B % {QB} == 0; got codes {tuple(codes.shape)}, B={b}")
    return n, d, b


def mma_min(q8: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """kB: [nt, B, 128] int32 window mins of q8 [B, D] int8 . codes [N, D] int8."""
    if codes.device.type == "cpu":
        return mma_min_ref(q8, codes)
    n, d, b = _check(codes, q8)
    out = torch.empty((n // SWEEP_TILE, b, WLANE), dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        rc = _kernels.library().mlvdb_int8_mma_min(
            codes.data_ptr(), q8.data_ptr(), out.data_ptr(), n, d, b,
            torch.cuda.current_stream(codes.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8 mma_min launch failed: cudaError {rc}")
    mma_min.launches += 1
    return out


def stream_sum(codes: torch.Tensor, batch: int) -> torch.Tensor:
    """kC: [nt, batch, 128] int32, each window's codes summed, for every query."""
    if codes.device.type == "cpu":
        return stream_sum_ref(codes, batch)
    n, d, b = _check(codes, batch=batch)
    out = torch.empty((n // SWEEP_TILE, b, WLANE), dtype=torch.int32, device=codes.device)
    with torch.cuda.device(codes.device):
        rc = _kernels.library().mlvdb_int8_stream_sum(
            codes.data_ptr(), out.data_ptr(), n, d, b,
            torch.cuda.current_stream(codes.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8 stream_sum launch failed: cudaError {rc}")
    stream_sum.launches += 1
    return out


mma_min.launches = 0
stream_sum.launches = 0
