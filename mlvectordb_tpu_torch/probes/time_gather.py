"""Time kernel B2 (``csrc/gather_score.cu``, the rescan) at the engine's operands and print
one JSON line: ``--rows`` x ``--dim`` rows of ``default_rng(42)`` (f32, and the same
rounded to bf16), a batch of ``--n-live`` queries (default 128) zero-padded to its bucket
(512), ``--s1`` sorted candidate windows of ``--r1`` rows a query (the padded queries
over one row's windows, as the engine's selection gives them); CUDA events around each
launch, mean of 20 after a warm one, with the 50 MB L2 cache flushed before each launch
("cold": the engine's phase 1 has just streamed the mirror through it) and back to back
("hot"); the card's name and power limit beside the times.

Two versions of the kernel compare only inside one call on one card, in turns (old, new,
new, old): run this file once per checkout, with that checkout first on the path,

    PYTHONPATH=<checkout> python <this file> [--s1 32 --r1 32]

so that the package imported, and built from its own ``csrc``, is the checkout's.  A
version whose wrapper takes ``n_live`` is timed on the live rows (as its engine calls
it) and on every row; an older one on every row (``"live_rows": false`` in the line).
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys

import numpy as np
import torch

_FLUSH = []


def time_ms(fn, iters: int = 20, cold: bool = True) -> float:
    """Mean device ms of ``fn()`` by CUDA events: around each call after flushing the L2
    cache (``cold``), or around ``iters`` calls back to back."""
    if not _FLUSH:
        # 1 GB: its zeroing (~0.3 ms) also lets the host enqueue the call ahead of the card
        _FLUSH.append(torch.empty(256 << 20, dtype=torch.float32, device="cuda"))
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters if cold else 1)]
    if cold:
        for start, end in ev:
            _FLUSH[0].zero_()
            start.record()
            fn()
            end.record()
    else:
        ev[0][0].record()
        for _ in range(iters):
            fn()
        ev[0][1].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / iters


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n-live", type=int, default=128)
    parser.add_argument("--bucket", type=int, default=512)
    parser.add_argument("--rows", type=int, default=1 << 20)
    parser.add_argument("--dim", type=int, default=128)
    parser.add_argument("--s1", type=int, default=32)
    parser.add_argument("--r1", type=int, default=32)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_gather: needs a CUDA GPU", file=sys.stderr)
        return 2
    from mlvectordb_tpu_torch.ops import fused_knn_t

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    n, d, b, nl, s1, r1 = args.rows, args.dim, args.bucket, args.n_live, args.s1, args.r1
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
    q = torch.zeros((b, d), device=dev)
    q[:nl] = torch.from_numpy(rng.standard_normal((nl, d), dtype=np.float32)).to(dev)
    f = np.sort(np.stack([rng.choice(n // r1, s1, replace=False) for _ in range(b)]), 1)
    f[nl:] = f[nl]
    f = torch.from_numpy(f.astype(np.int32)).to(dev)
    live = "n_live" in inspect.signature(fused_knn_t._gather_score).parameters
    fn = fused_knn_t._gather_score
    out = {"package": fused_knn_t.__file__, "card": card, "rows": n, "dim": d, "s1": s1,
           "r1": r1, "bucket": b, "n_live": nl, "live_rows": live}
    for rows in (torch.float32, torch.bfloat16):
        data = x.to(rows)
        tag = "" if rows == torch.float32 else "_bf16"
        for cold in (True, False):
            temp = "" if cold else "_hot"
            out["full" + tag + temp + "_ms"] = time_ms(lambda: fn(q, data, f, r1=r1), cold=cold)
            if live:
                out["live" + tag + temp + "_ms"] = time_ms(
                    lambda: fn(q, data, f, r1=r1, n_live=nl), cold=cold)
        del data
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
