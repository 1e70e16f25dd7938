"""Time kernels B4 and B5 (``csrc/window_min.cu``) at the engine's shape and print one JSON
line: 2^20 x 128 f32 rows of ``default_rng(42)``, B = 512 queries (the bucket of a B=128
batch), l2, the engine's r1, 1,000 tombstones in B5's bias row; CUDA events, mean of 20
calls after a warm one; the card's name and power limit beside the times.

Two versions of the kernels compare only inside one call on one card, in turns (old,
new, new, old): run this file once per checkout, with that checkout first on the path,

    PYTHONPATH=<checkout> python <this file>

so that the package imported, and built from its own ``csrc``, is the checkout's.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch


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


def main() -> int:
    if not torch.cuda.is_available():
        print("time_window_min: needs a CUDA GPU", file=sys.stderr)
        return 2
    from mlvectordb_tpu_torch.ops import fused_knn
    from mlvectordb_tpu_torch.ops.distances import MASKED

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    n, d, b = 1 << 20, 128, 512
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    data = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(dev)
    qt, qn = q.T.contiguous(), (q * q).sum(-1)[None, :].contiguous()
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[torch.from_numpy(rng.choice(n, 1000, replace=False)).to(dev)] = False
    bias = ((data * data).sum(-1) + torch.where(valid, 0.0, float(MASKED)))[:, None]
    bias = bias.contiguous()
    kw = dict(metric="l2", db_tile=fused_knn.DB_TILE, r1=fused_knn._pick_r1(b, n, 16))
    out = {"package": fused_knn.__file__, "card": card, "r1": kw["r1"],
           "fast_ms": _time_ms(lambda: fused_knn._window_mins_fast(data, qt, qn, n, **kw)),
           "masked_ms": _time_ms(
               lambda: fused_knn._window_mins_masked(data, qt, qn, bias, **kw))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
