"""Time kernel B3 (``csrc/sweep_min.cu``) over an f32 mirror at the engine's operands and
print one JSON line: ``QueryProcessor`` with ``EngineConfig(sweep_dtype="float32")`` (an
f32 store, its rows the mirror) and with ``EngineConfig(dtype="bfloat16",
sweep_dtype="float32")`` (a bf16 store's f32 mirror, one bound row), each over 2^20 x 128
rows of ``default_rng(42)`` with 1,000 of them deleted; B3's operands captured from the
engine's own searches at k = 10: l2 at B = 128 (the 512 bucket), ip and cosine at B = 16
(the 64 bucket).  Then the f32 store at wider rows, l2 at B = 128 and ip at B = 16:
2^20 x 384 and 2^19 x 1536 (the width of OpenAI's text-embedding-ada-002).  Each call is
timed as the engine makes it (the live columns and the snapshot's cached zero-query
column) and over every column of the bucket; CUDA events, mean of 20 calls after a warm
one, back to back; the card's name and power limit beside the times.  Each live call's
bound (``_bound_ms``): the mirror, queries and outputs moved once over 3.35 TB/s, or the
live columns' products as six bf16 passes over 989 TFLOP/s, whichever is longer; and
``_bound_fma_ms``, the same products as one f32 pass over 67 TFLOP/s (the CUDA cores).

Two versions of the kernel compare only inside one call on one card, in turns (old, new,
new, old): run this file once per checkout, with that checkout first on the path,

    PYTHONPATH=<checkout> python <this file>

so that the package imported, and built from its own ``csrc``, is the checkout's
(``"body"`` in the line: "fma" where its ``sweep_min.cu`` still holds the FMA body).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SEARCHES = (("l2", 128, 512), ("ip", 16, 64), ("cosine", 16, 64))
# name: (config, rows, dimensions, searches)
CONFIGS = {"f32_store": (dict(sweep_dtype="float32"), 1 << 20, 128, SEARCHES),
           "bf16_store": (dict(dtype="bfloat16", sweep_dtype="float32"), 1 << 20, 128, SEARCHES),
           "f32_store_dp384": (dict(sweep_dtype="float32"), 1 << 20, 384, SEARCHES[:2]),
           "f32_store_dp1536": (dict(sweep_dtype="float32"), 1 << 19, 1536, SEARCHES[:2])}
HBM_BPS, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12


def _time_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bounds_ms(fused_knn_t, a, kw):
    """(bound, FMA route's bound) in ms of the live call ``a``, ``kw``."""
    outs = fused_knn_t._window_mins_t(*a, **kw)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*a, kw.get("qe"), *kw.get("eb_rows", ()), *outs) if t is not None)
    cap, dim = a[2].shape
    ops = 2.0 * cap * dim * fused_knn_t._live_columns(a[0].shape[0], kw.get("n_live"))
    return (max(nbytes / HBM_BPS, 6 * ops / BF16_FLOPS) * 1e3,
            max(nbytes / HBM_BPS, ops / F32_FLOPS) * 1e3)


def _captured(fused_knn_t, qp, queries, metric):
    """The (args, kwargs) of the first ``_window_mins_t`` call of the engine's search."""
    from mlvectordb_tpu_torch import VectorDTO

    real, seen = fused_knn_t._window_mins_t, []

    def spy(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)

    spy.__dict__.update(real.__dict__)
    fused_knn_t._window_mins_t = spy
    try:
        qp.find_similar_batch([VectorDTO(v) for v in queries], 10, "ns", metric)
    finally:
        fused_knn_t._window_mins_t = real
        real.__dict__.update(spy.__dict__)
    return seen[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("time_sweep: needs a CUDA GPU", file=sys.stderr)
        return 2
    from mlvectordb_tpu_torch import EngineConfig, QueryProcessor
    from mlvectordb_tpu_torch.ops import fused_knn_t

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    src = Path(fused_knn_t.__file__).resolve().parent.parent / "csrc" / "sweep_min.cu"
    out = {"package": fused_knn_t.__file__, "card": card,
           "body": "fma" if "fma_kernel" in src.read_text() else "mma"}
    data = {}
    for name, (cfg, n, dim, searches) in CONFIGS.items():
        if (n, dim) not in data:
            data.clear()
            rng = np.random.default_rng(42)
            db = rng.standard_normal((n, dim), dtype=np.float32)
            data[n, dim] = (db, rng.standard_normal((128, dim), dtype=np.float32),
                            rng.choice(n, 1000, replace=False))
        db, queries, dead = data[n, dim]
        qp = QueryProcessor(EngineConfig(**cfg), device="cuda")
        ids = qp.bulk_load(db, "ns")
        qp.delete([ids[i] for i in dead], "ns")
        for metric, nq, bucket in searches:
            a, kw = _captured(fused_knn_t, qp, queries[:nq], metric)
            if a[2].dtype != torch.float32 or a[0].shape[0] != bucket or kw.get("n_live") != nq:
                raise AssertionError(f"{name} {metric}: not the f32 mirror's live launch: "
                                     f"{a[2].dtype} {tuple(a[0].shape)} {kw.get('n_live')}")
            key = f"{name}_{metric}_b{nq}"
            out[key + "_ms"] = _time_ms(lambda: fused_knn_t._window_mins_t(*a, **kw))
            full = {**kw, "n_live": None, "zero_cache": None}
            out[key + "_full_ms"] = _time_ms(lambda: fused_knn_t._window_mins_t(*a, **full))
            out[key + "_r1"] = kw["r1"]
            out[key + "_bound_ms"], out[key + "_bound_fma_ms"] = _bounds_ms(fused_knn_t, a, kw)
        del qp, ids
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
