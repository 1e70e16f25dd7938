"""What sets the sweep kernel's time on the card: the tensor-core body with one part
removed at a time.

Builds variants of ``csrc/sweep_min.cu`` (text edits, under ``build/kernels/ablation/``),
each without one part of the tensor-core body — the products (``no_products``: the mma
instructions, the operands still loaded), the epilogue (``no_epilogue``: the per-row
terms and the rank formula), the mirror's cp.async stream (``no_mirror_loads``), the
per-row term loads (``no_row_terms``) — and times each beside the full kernel
(``full``) at the engine's bf16-light operands: 2^20 x 128 rows of ``default_rng(42)``,
B = 512 of which 128 are live, l2, r1 = 32 with the block mins, the live columns only.
``narrow_tile`` is the full kernel on 8 live queries (its 16-query tile).  The variants
compute wrong values; only their times mean anything.  CUDA events, mean of 20 calls
after a warm one; prints the card's name and power limit and one JSON line.

    python -m mlvectordb_tpu_torch.probes.sweep_ablation
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

# (the text of csrc/sweep_min.cu a variant replaces, what it puts there)
VARIANTS = {
    "no_products": [(
        "          mma_bf16(acc1[n], lo.x, hi.x, lo.y, hi.y, b[n].x, b[n].y);\n"
        "          mma_bf16(acc1[n], lo.z, hi.z, lo.w, hi.w, b[n].z, b[n].w);",
        "          acc1[n][0] += __uint_as_float(lo.x & b[n].x);\n"
        "          acc1[n][1] += __uint_as_float(hi.w & b[n].w);")],
    "no_epilogue": [("        float dots = acc1[n][e];",
                     "        float dots = acc1[n][e];\n        rk[e] = dots;\n        continue;")],
    "no_mirror_loads": [("    cp_async_wait<NST - 2>();\n", ""),
                        ("    if (z + NST - 1 < total) issue(z + NST - 1);\n", "")],
    "no_row_terms": [("        rb[h] = a.bias ? a.bias[rw] : 0.f;\n"
                      "        rsc[h] = a.scale ? a.scale[rw] : 1.f;\n"
                      "        rrs[h] = RESID ? a.rscale[rw] : 0.f;\n"
                      "        re1[h] = a.n_eb > 0 ? a.eb1[rw] : 0.f;\n"
                      "        re2[h] = a.n_eb > 1 ? a.eb2[rw] : 0.f;",
                      "        rb[h] = rsc[h] = rrs[h] = re1[h] = re2[h] = (float)(rw & 1);")],
    # the light program's query tile at 64 and 32 queries (8 and 4 n-tiles): more blocks,
    # each with a shorter unrolled body (these compute the right values)
    "tile_64": [("RESID || IS_F32<MT>) ? 4 : 8;", "RESID || IS_F32<MT>) ? 4 : 4;")],
    "tile_32": [("RESID || IS_F32<MT>) ? 4 : 8;", "RESID || IS_F32<MT>) ? 4 : 2;")],
}


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


def _build_variants():
    """{variant: the loaded library's mlvdb_sweep_min}, compiled in parallel."""
    from mlvectordb_tpu_torch.ops import _kernels

    src = (_kernels._CSRC / "sweep_min.cu").read_text()
    out = _kernels.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel source no longer holds {old[:50]!r}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_kernels._nvcc(), *_kernels._ARCH, "-I", str(_kernels._CSRC), "-Xcompiler",
             "-fPIC", "-shared", "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {"full": _kernels.library().mlvdb_sweep_min}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}: {log}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).mlvdb_sweep_min
        fn.argtypes, fn.restype = fns["full"].argtypes, fns["full"].restype
        fns[name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_ablation: needs a CUDA GPU", file=sys.stderr)
        return 2
    from mlvectordb_tpu_torch.ops import fused_knn_t as T

    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    n, d, b, live = 1 << 20, 128, 512, 128
    data = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
    q = torch.zeros((b, d), device=dev)
    q[:live] = torch.from_numpy(rng.standard_normal((live, d), dtype=np.float32)).to(dev)
    z, s, e2, e1 = T.quantize_resid_rows(data)
    prep = T._prep_terms(torch.ones(n, dtype=torch.bool, device=dev), (data * data).sum(-1), n,
                         s, e2, e1, cap=n, metric="l2", masked=True, use_resid=False,
                         wb_sources=("err1", "sqn_sqrt"))
    qh, _, qres_f32 = T._fold_query(q, "l2", True, torch.bfloat16)
    qe = torch.zeros((live, 2), device=dev)
    qe[:, 0] = torch.linalg.vector_norm(q[:live], dim=1) * 2.0
    qe[:, 1] = torch.linalg.vector_norm(qres_f32[:live], dim=1)
    mirror = data.to(torch.bfloat16)
    eb1, eb2 = prep["eb_rows"]
    out = torch.empty((n // T.SWEEP_TILE, b, T.WLANE), device=dev)
    bm = torch.empty((n // T.SWEEP_TILE, b), device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, cols):
        def run():
            rc = fn(qh[:cols].data_ptr(), None, mirror.data_ptr(), None, None, None,
                    prep["bias_row"].data_ptr(), qe.data_ptr(), eb1.data_ptr(), eb2.data_ptr(),
                    out.data_ptr(), bm.data_ptr(), None, n, d, b, cols, cols, 32, 2, 0, 0, 0,
                    stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: cudaError {rc}")
        return run

    fns = _build_variants()
    times = {name: _time_ms(call(fn, live)) for name, fn in fns.items()}
    times["narrow_tile"] = _time_ms(call(fns["full"], 8))
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(gpu)
    print(json.dumps({"sweep_ablation_ms": times, "rows": n, "live_queries": live}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
