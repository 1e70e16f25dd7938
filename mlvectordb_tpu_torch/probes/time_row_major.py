"""Time the row-major path (``exact_knn_fused``: kernel B4 or B5, the selection, the rescan,
the float64 settle and, where the checkout has it, the per-query proof of ROADMAP C20) and
print one JSON line.

On the card (the default): phase 3's and phase 11's cell of ``chip_smoke.py``, 2^20 x 128
gaussian rows and then 128 gaussian queries of ``default_rng(42)``, stored f32 and bf16,
the queries padded to the engine's 512 bucket, k bucket 16, l2:

  * ``fused_{fast,masked}_{f32,bf16}``: ``exact_knn_fused(..., n_live=128, defer=True)``,
    the device result with its flags and, with the proof, the proof, no host read: CUDA
    events (``_ms``) and the host clock with a synchronize after each call (``_wall_ms``),
    each the mean of 20 calls after a warm one; ``masked`` after 1,000 deletes;
  * ``engine_{fast,masked}_{f32,bf16}_ms``: the median host wall of 9
    ``QueryProcessor.find_similar_batch`` calls at B = 128, k = 10 (distinct queries, so
    the result cache serves none), with the tiers they were served at where the checkout
    records them;

the card's name and power limit beside them.  Two versions compare only inside one call
on one card, in turns (old, new, new, old): run this file once per checkout, with that
checkout first on the path,

    PYTHONPATH=<checkout> python <this file>

``--profile-cpu``: the operator calls (``aten::`` events at the top of the profile's
tree; ``_nonview`` those that are not views, each one kernel or more on the card) of
one deferred ``exact_knn_fused`` on the CPU, read by ``torch.profiler`` at 16,384 x 128
rows, B = 8, k = 16, l2, fast and masked: no card.  Where the checkout keeps the proof's
coefficients in a prep dict, both modes pass one, warm, as the engine's snapshot does.
"""

from __future__ import annotations

import inspect
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def _time_ms(fn, iters: int = 20):
    """(CUDA-event ms, host-clock ms) per call, each the mean of ``iters`` after a warm one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    event = start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return event, (time.perf_counter() - t0) * 1e3 / iters


def _prep_kw(fused_knn) -> dict:
    """A prep dict for the checkout's ``exact_knn_fused`` where it takes one (the proof's
    coefficients are kept there per snapshot, as the engine keeps them)."""
    return {"prep_cache": {}} if "prep_cache" in inspect.signature(
        fused_knn.exact_knn_fused).parameters else {}


# operator calls that make a view or return their input: no launch on the card
VIEWS = {"aten::alias", "aten::as_strided", "aten::contiguous", "aten::detach",
         "aten::expand", "aten::lift_fresh", "aten::numpy_T", "aten::permute",
         "aten::reshape", "aten::select", "aten::slice", "aten::squeeze", "aten::t",
         "aten::transpose", "aten::unsqueeze", "aten::view"}


def _top_level_ops(fn):
    """(all, non-view): the ``aten::`` events of ``fn`` with no ``aten::`` event around
    them, and those of them not in ``VIEWS``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = sorted((e for e in prof.events() if e.name.startswith("aten::")),
                    key=lambda e: (e.time_range.start, -e.time_range.end))
    count, nonview, end = 0, 0, -1
    for e in events:
        if e.time_range.start >= end:
            count += 1
            nonview += e.name not in VIEWS
            end = e.time_range.end
    return count, nonview


def profile_cpu() -> dict:
    from mlvectordb_tpu_torch.ops import fused_knn

    rng = np.random.default_rng(1234)
    n, d, b = 16384, 128, 8
    data = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32))
    valid = torch.ones(n, dtype=torch.bool)
    valid[:: 97] = False
    sq = (data.double() ** 2).sum(-1).float()
    out = {}
    for name, lp, v in (("fast", n, torch.ones(n, dtype=torch.bool)), ("masked", None, valid)):
        kw = _prep_kw(fused_knn)

        def call():
            fused_knn.exact_knn_fused(q, data, v, sq, k=16, metric="l2", live_prefix=lp,
                                      defer=True, **kw)
        call()
        out[f"ops_{name}"], out[f"ops_{name}_nonview"] = _top_level_ops(call)
    return out


def main() -> int:
    import mlvectordb_tpu_torch

    if "--profile-cpu" in sys.argv:
        print(json.dumps({"package": str(mlvectordb_tpu_torch.__file__), **profile_cpu()}))
        return 0
    if not torch.cuda.is_available():
        print("time_row_major: needs a CUDA GPU (or --profile-cpu)", file=sys.stderr)
        return 2
    from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
    from mlvectordb_tpu_torch.ops import fused_knn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    n, d, b = 1 << 20, 128, 128
    db_np = rng.standard_normal((n, d), dtype=np.float32)
    q_np = rng.standard_normal((b, d), dtype=np.float32)
    dead = rng.choice(n, 1000, replace=False)
    q_pad = torch.zeros((512, d), device=dev)
    q_pad[:b] = torch.from_numpy(q_np).to(dev)
    out = {"card": card, "package": str(mlvectordb_tpu_torch.__file__), "rows": n, "dim": d,
           "batch": b, "bucket": 512, "k_bucket": 16}
    for dtype in ("float32", "bfloat16"):
        tag = "f32" if dtype == "float32" else "bf16"
        qp = QueryProcessor(EngineConfig(dtype=dtype), device=dev)
        ids = qp.bulk_load(db_np, "ns")
        for variant in ("fast", "masked"):
            if variant == "masked":
                qp.delete([ids[i] for i in dead], "ns")
            st = qp.storage.namespace("ns").device_state()
            lp = None if variant == "masked" else st.high_water
            kw = _prep_kw(fused_knn)

            def fused():
                fused_knn.exact_knn_fused(q_pad, st.data, st.valid, st.sq_norms, k=16,
                                          metric="l2", live_prefix=lp, n_live=b, defer=True,
                                          **kw)

            event, wall = _time_ms(fused)
            out[f"fused_{variant}_{tag}_ms"] = event
            out[f"fused_{variant}_{tag}_wall_ms"] = wall
            walls = []
            for i in range(10):
                qs = [VectorDTO(v) for v in q_np + np.float32(i + 1) * np.float32(1e-3)]
                t0 = time.perf_counter()
                qp.find_similar_batch(qs, 10, "ns", "l2")
                walls.append((time.perf_counter() - t0) * 1e3)
            out[f"engine_{variant}_{tag}_ms"] = statistics.median(walls[1:])
            out[f"engine_{variant}_{tag}_tiers"] = qp.cert_tier_counts("ns")
        del qp, st
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
