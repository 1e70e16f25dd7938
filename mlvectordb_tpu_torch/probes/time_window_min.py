"""Time kernels B4 and B5 (``csrc/window_min.cu``) at the engine's operands and print one
JSON line: 2^20 x 128 rows of ``default_rng(42)`` (``--rows`` x ``--dim``; f32, and the
same rounded to bf16), a batch of ``--n-live`` queries (default 128) zero-padded to its
bucket (512), l2, r1 from the padded batch as the engine picks it, 1,000 tombstones in
B5's bias row; CUDA events, mean of 20 calls after a warm one; the card's name and power
limit beside the times, and a sha256 of each kernel's outputs (``outputs_sha256``), so
that two checkouts' kernels compare bit for bit.

Two versions of the kernels compare only inside one call on one card, in turns (old,
new, new, old): run this file once per checkout, with that checkout first on the path,

    PYTHONPATH=<checkout> python <this file> [--n-live 128]

so that the package imported, and built from its own ``csrc``, is the checkout's.  A
version whose wrappers take ``n_live`` computes the live columns alone, as its engine
does; an older one computes every column of the bucket, as its engine did
(``"live_columns": false`` in the line).
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
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
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n-live", type=int, default=128)
    parser.add_argument("--bucket", type=int, default=512)
    parser.add_argument("--rows", type=int, default=1 << 20)
    parser.add_argument("--dim", type=int, default=128)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_window_min: needs a CUDA GPU", file=sys.stderr)
        return 2
    from mlvectordb_tpu_torch.ops import fused_knn
    from mlvectordb_tpu_torch.ops.distances import MASKED

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    n, d, b = args.rows, args.dim, args.bucket
    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
    q = torch.zeros((b, d), device=dev)
    q[:args.n_live] = torch.from_numpy(
        rng.standard_normal((args.n_live, d), dtype=np.float32)).to(dev)
    qn = (q * q).sum(-1)[None, :].contiguous()
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[torch.from_numpy(rng.choice(n, 1000, replace=False)).to(dev)] = False
    bias = ((x * x).sum(-1) + torch.where(valid, 0.0, float(MASKED)))[:, None].contiguous()
    live = "n_live" in inspect.signature(fused_knn._window_mins_fast).parameters
    kw = dict(metric="l2", db_tile=fused_knn.DB_TILE, r1=fused_knn._pick_r1(b, n, 16),
              **({"n_live": args.n_live} if live else {}))
    out = {"package": fused_knn.__file__, "card": card, "rows": n, "dim": d, "r1": kw["r1"],
           "bucket": b, "n_live": args.n_live, "live_columns": live, "outputs_sha256": {}}
    for rows in (torch.float32, torch.bfloat16):
        data = x.to(rows)
        qt = q.T.to(rows).float().contiguous()
        tag = "" if rows == torch.float32 else "_bf16"
        for name, fn, arg in (("fast", fused_knn._window_mins_fast, n),
                              ("masked", fused_knn._window_mins_masked, bias)):
            out[name + tag + "_ms"] = _time_ms(lambda: fn(data, qt, qn, arg, **kw))
            got = fn(data, qt, qn, arg, **kw).cpu().numpy().tobytes()
            out["outputs_sha256"][name + tag] = hashlib.sha256(got).hexdigest()
        del data
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
