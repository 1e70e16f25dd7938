"""Time the three exact paths whose top k the port settles in float64 (ROADMAP C18) and
print one JSON line: 2^20 x 128 gaussian f32 rows of ``default_rng(42)``, 1,000 of them
dead, 128 gaussian queries, k = 16, l2 and cosine:

  * ``sweep``: the certified sweep (``exact_knn_t``, a bf16 mirror with its error norms,
    the heavy program, masked), deferred: phase 1, selection, B2's rescan, the settle and
    the proof, with no host read;
  * ``row_major``: ``exact_knn_fused`` over the masked kernel B5 with its rescan, to its
    device result;
  * ``scan``: ``topk.exact_knn`` with the f32 query, 32,768-row tiles (the sweep's tier 2).

Each as the mean of 20 calls after a warm one: by CUDA events (``*_ms``) and by the host
clock with a synchronize after each call (``*_wall_ms``, which holds a host read of the
settle's flags where a version makes one); the card's name and power limit beside them.
Two versions compare only inside one call on one card, in turns (old, new, new, old):
run this file once per checkout, with that checkout first on the path,

    PYTHONPATH=<checkout> python <this file>
"""

from __future__ import annotations

import json
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


def main() -> int:
    if not torch.cuda.is_available():
        print("time_settle: needs a CUDA GPU", file=sys.stderr)
        return 2
    import mlvectordb_tpu_torch
    from mlvectordb_tpu_torch.ops import fused_knn, fused_knn_t, topk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    n, d, b, k = 1 << 20, 128, 128, 16
    data = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[torch.from_numpy(rng.choice(n, 1000, replace=False)).to(dev)] = False
    sq = (data.double() ** 2).sum(-1).float()
    mirror = data.to(torch.bfloat16)
    err = fused_knn_t.sweep_err_norms(data)
    out = {"card": card, "package": str(mlvectordb_tpu_torch.__file__), "rows": n, "dim": d,
           "batch": b, "k": k}
    for metric in ("l2", "cosine"):
        prep = {}

        def sweep():
            fused_knn_t.exact_knn_t(q, mirror, data, valid, sq, k=k, metric=metric,
                                    sweep_err=err, light=False, prep_cache=prep, defer=True)

        calls = {
            "sweep": sweep,
            "row_major": lambda: fused_knn.exact_knn_fused(q, data, valid, sq, k=k,
                                                           metric=metric, live_prefix=None),
            "scan": lambda: topk.exact_knn(q, data, valid, sq, k=k, metric=metric,
                                           db_tile=8 * fused_knn_t.SWEEP_TILE,
                                           round_query=False),
        }
        for name, fn in calls.items():
            event, wall = _time_ms(fn)
            out[f"{name}_{metric}_ms"] = event
            out[f"{name}_{metric}_wall_ms"] = wall
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
