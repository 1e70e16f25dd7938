"""The rescan kernel B2 beside the bulk-copy ring that computes the same: which is faster on
the card.

Builds ``csrc/gather_score.cu`` (the deep-load kernel, ``current``) and
``gather_bulk_ring.cu`` beside this file (whole windows streamed into shared memory by
``cp.async.bulk`` from a producer warp, 8 KB stages, 4 deep: ``ring``; and the same built
with ``-DRING_NO_COPIES``, whose barriers complete with no bytes moved, the ring's
synchronisation floor: ``ring_no_copies``, whose values are wrong and only its time means
anything) under
``build/kernels/gather_variants/`` and times each by calling its C entry directly (no
wrapper: the kernel alone) on the operands of the engine's live launch: 129 query rows
(128 live and the first padded row of the 512 bucket), 2^20 x 128 rows of
``default_rng(42)`` (f32, and rounded to bf16) with 32 sorted windows of 32 rows a query
(k bucket 16) and 160 of 16 (k bucket 128), and 2^18 x 1536 rows with 32 of 32.  CUDA
events around each launch with the L2 cache flushed before it, mean of 20; prints the
card's name and power limit, a line per timing and one JSON line with each variant's
error over the card tests' bound of the plain version and whether its outputs equal the
kernel's bit for bit.

    python -m mlvectordb_tpu_torch.probes.gather_variants [--extra NAME=PATH.cu ...]

``--extra`` adds another source with the same C entry, ``mlvdb_gather_score`` with its
``n_out`` argument (an earlier checkout's kernel of another signature is timed through
its own wrapper by ``probes/time_gather.py``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

RING = Path(__file__).with_name("gather_bulk_ring.cu")

# (name, rows, dim, s1, r1)
SHAPES = (("k16", 1 << 20, 128, 32, 32), ("k128", 1 << 20, 128, 160, 16),
          ("dp1536", 1 << 18, 1536, 32, 32))


def _build(name, source, flags=()):
    """The nvcc command of a variant, and the library it writes."""
    from mlvectordb_tpu_torch.ops import _kernels

    out = _kernels.BUILD_DIR / "gather_variants"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"{name}.so"
    return [_kernels._nvcc(), *_kernels._ARCH, *flags, "-Xcompiler", "-fPIC", "-shared", "-o",
            str(so), str(Path(source).resolve())], so


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--extra", action="append", default=[], metavar="NAME=PATH")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gather_variants: needs a CUDA GPU", file=sys.stderr)
        return 2
    from mlvectordb_tpu_torch.ops import _kernels, fused_knn_t
    from mlvectordb_tpu_torch.probes.time_gather import time_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    builds = {"current": _build("current", _kernels._CSRC / "gather_score.cu"),
              "ring": _build("ring", RING),
              "ring_no_copies": _build("ring_no_copies", RING, ["-DRING_NO_COPIES"])}
    for extra in args.extra:
        name, path = extra.split("=", 1)
        builds[name] = _build(name, path)
    procs = {n: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)
             for n, (cmd, _) in builds.items()}
    entries = {}
    for n, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {n} did not build:\n{text}")
        fn = ctypes.CDLL(str(builds[n][1])).mlvdb_gather_score
        fn.argtypes = _kernels.library().mlvdb_gather_score.argtypes
        fn.restype = ctypes.c_int
        entries[n] = fn

    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    n_c = 129
    out = {"card": card, "query_rows": n_c}
    stream = torch.cuda.current_stream().cuda_stream
    for shape, n, d, s1, r1 in SHAPES:
        x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
        q = torch.from_numpy(rng.standard_normal((n_c, d), dtype=np.float32)).to(dev)
        f = np.sort(np.stack([rng.choice(n // r1, s1, replace=False) for _ in range(n_c)]), 1)
        f = torch.from_numpy(f.astype(np.int32)).to(dev)
        dots = torch.empty((n_c, s1 * r1), device=dev)
        sqn = torch.empty_like(dots)
        for rows in (torch.float32, torch.bfloat16):
            data = x.to(rows)
            for name, fn in entries.items():

                def call():
                    rc = fn(q.data_ptr(), data.data_ptr(), f.data_ptr(), dots.data_ptr(),
                            sqn.data_ptr(), n_c, n_c, s1, r1, d, n // r1,
                            _kernels.ROW_TYPES[rows], stream)
                    if rc:
                        raise RuntimeError(f"{name}: cudaError {rc}")

                key = f"{shape}_{'f32' if rows == torch.float32 else 'bf16'}_{name}"
                out[key + "_ms"] = time_ms(call)
                if name == "current":
                    ref = (dots.clone(), sqn.clone())
                else:
                    out[key + "_bits_equal"] = bool(
                        torch.equal(dots.view(torch.int32), ref[0].view(torch.int32))
                        and torch.equal(sqn.view(torch.int32), ref[1].view(torch.int32)))
                print(f"  {key}: {out[key + '_ms']:.4f} ms", flush=True)
                if name == "ring_no_copies":
                    continue
                # within the card tests' bound of the plain version
                wd, ws = fused_knn_t._gather_score_ref(q, data, f, r1=r1)
                bound = d * 2.0 ** -24 * (torch.linalg.vector_norm(q, dim=1)[:, None]
                                          * ws.sqrt() + ws)
                ratio = max(float(((dots - wd).abs() / bound).max()),
                            float(((sqn - ws).abs() / bound).max()))
                out[key + "_err_over_bound"] = ratio
                if not ratio <= 1.0:
                    raise AssertionError(f"{key}: |err| / bound {ratio}")
            del data
        del x
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
