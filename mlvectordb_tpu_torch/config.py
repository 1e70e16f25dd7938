"""Typed configuration for the PyTorch + CUDA engine.

A copy of ``mlvectordb_tpu/config.py`` (importing that module pulls in JAX through
``mlvectordb_tpu/__init__.py``).  Every field is kept, so a config compares one to one
with the JAX package's; combinations not yet ported (a bf16 store with an int8 or f32
sweep mirror) are accepted here and rejected by the store.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Metrics supported by the engine.  These mirror the reference's hnswlib spaces
# (reference: src/mlvectordb/implementations/index.py:18 — "l2", "ip", "cosine") plus the
# aliases its README/examples use ("euclidean", "dot").
METRICS = ("l2", "ip", "cosine")
METRIC_ALIASES = {
    "l2": "l2",
    "euclidean": "l2",
    "ip": "ip",
    "dot": "ip",
    "inner_product": "ip",
    "cosine": "cosine",
}

# Score conventions, kept byte-compatible with the reference
# (reference: src/mlvectordb/implementations/index.py:121-128):
#   l2     -> squared euclidean distance (lower is better)
#   ip     -> 1 - <q, d>                 (lower is better)
#   cosine -> cosine similarity          (higher is better; reference returns 1 - dist)
HIGHER_IS_BETTER = {"l2": False, "ip": False, "cosine": True}


def canonical_metric(metric: str) -> str:
    m = METRIC_ALIASES.get(metric.lower())
    if m is None:
        raise ValueError(f"unknown metric {metric!r}; supported: {sorted(METRIC_ALIASES)}")
    return m


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-wide configuration.

    Shapes are always static under jit: capacities grow in powers of two, query batches are
    bucketed, and the vector dimension is padded to a lane multiple, so the set of compiled
    programs stays small and cached.
    """

    # Storage dtype for the database matrix.  bfloat16 halves HBM traffic on the scan;
    # accumulation is always float32 on the MXU (preferred_element_type).
    dtype: str = "float32"  # "float32" | "bfloat16"

    # Optional sweep mirror (kept in sync with the store; the port's is row-major
    # [capacity, dpad], the JAX package's transposed): the phase-1 window ranking reads
    # it (ops/fused_knn_t.py) while the exact rescan + hydration read the primary
    # row-major matrix.  "bfloat16" = recommended serving config (+50% HBM for ~2-3x
    # QPS; candidate scoring stays exact f32 — the bench recall gate and oracle tests
    # pin set-exactness); "float32" = +100% HBM, HIGHEST-precision ranking; "int8" =
    # per-row-scaled codes at 1 byte/element (phase 1 at ~2x the bf16 bandwidth
    # headroom; the exactness certificate carries the quantization-error bounds and
    # escalates when int8 resolution is not enough); None (default) = no mirror,
    # row-major kernel, provably exact selection margin.
    sweep_dtype: Optional[str] = None  # None | "bfloat16" | "float32" | "int8"

    # Slots allocated for a fresh namespace; grows by powers of two up to max_capacity.
    initial_capacity: int = 4096
    max_capacity: int = 1 << 27

    # Pad the feature dimension up to a multiple of this (TPU lane width).
    lane: int = 128
    # Pad/round capacity to a multiple of this (sublane * pipeline friendliness).
    capacity_multiple: int = 512

    # Database-axis tile for the streaming scan / pallas grid.
    db_tile: int = 8192
    # Query-batch bucket sizes (powers of two); singles run in the smallest bucket.
    query_buckets: Tuple[int, ...] = (8, 64, 512, 4096)
    # k is bucketed too so compiled program count stays bounded. 1000 mirrors the
    # reference's top_k upper bound (reference: src/mlvectordb/api/rest_api.py:24).
    k_buckets: Tuple[int, ...] = (16, 128, 1024)

    default_metric: str = "l2"

    # Tombstone ratio that triggers per-namespace compaction
    # (reference: src/mlvectordb/implementations/index.py:84-89 rebuild_threshold=0.2 —
    # but unlike the reference's Index.rebuild, compaction here never touches other
    # namespaces; see SURVEY.md §3.4 for the reference's cross-namespace wipe bug).
    rebuild_threshold: float = 0.2

    # Use the fused kernel path (ops/fused_knn.exact_knn_fused: hand-written CUDA
    # window-min kernels on a CUDA device, their plain torch versions on the CPU);
    # False = the tiled scan (ops/topk.exact_knn).  The name is the JAX package's.
    use_pallas: bool = True

    # Residual-corrected sweep (lossy-sweep configs): keep an int8 quantization of
    # each row's sweep-representation residual alongside the mirror (+1 byte/element
    # HBM, one extra VMEM matmul in phase 1).  For the mixed f32-store/bf16-sweep
    # config the codes encode delta = row - bf16(row); for sweep_dtype="int8" they
    # encode delta1 = row - s1*z1 (two-level int8: 2 B/element total, the cheapest
    # certified tier — less HBM *and* less MXU than bf16+resid at a comparable
    # band).  Either way the exactness certificate's data-side error band shrinks
    # ~2^-8x, so the certified fast tier passes even on tightly clustered corpora
    # whose neighbour gaps sit far below the raw quantization band — proof at
    # margin-mode speed instead of a fallback scan (ops/pallas_knn_t._sweep_kernel).
    sweep_resid: bool = True

    # Exactness certificate (ops/pallas_knn_t._fused_t): every bf16-sweep search
    # proves on device that no pruned window can hold a true neighbour, escalating to
    # wider selection / a full exact scan when the proof fails.  True (default) =
    # machine-checked exactness on EVERY query; on tightly clustered corpora whose
    # neighbour gaps sit below the bf16 error band this escalates by design (the
    # proof is the product).  False = return the fast tier unconditionally: exactness
    # then rests on the empirical selection margin + the benchmark recall gates
    # (the round-2 contract) — a documented speed/proof trade.
    certify_exact: bool = True

    # Adaptive certified dispatch (mixed bf16-sweep configs): serve each namespace
    # with the LIGHT single-pass certified program first — one MXU pass, no residual
    # stream; the certificate carries the uncompensated query-rounding term per
    # window — and switch the namespace to the heavy residual-corrected program
    # permanently once an escalation shows its corpus gaps sit under the light
    # band.  Escalations are proof-gated (exact results, just slower); eager torch
    # compiles nothing, so the port switches at once after the escalating batch.
    # False = always dispatch the heavy program (round-4 behavior).
    adaptive_certify: bool = True

    # Query-result cache entries (0 disables).  Keyed by namespace version, so any
    # mutation invalidates implicitly.  Realizes the result caching the reference README
    # advertises but never shipped (SURVEY.md §0.1).
    result_cache_size: int = 1024

    def bucket_batch(self, n: int) -> int:
        for b in self.query_buckets:
            if n <= b:
                return b
        return _next_pow2(n)

    def bucket_k(self, k: int) -> int:
        for b in self.k_buckets:
            if k <= b:
                return b
        return _next_pow2(k)

    def pad_dim(self, dim: int) -> int:
        return -(-dim // self.lane) * self.lane

    def round_capacity(self, n: int) -> int:
        cap = max(self.initial_capacity, _next_pow2(n))
        m = self.capacity_multiple
        return -(-cap // m) * m


DEFAULT_CONFIG = EngineConfig()
