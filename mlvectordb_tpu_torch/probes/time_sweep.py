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

``--routes`` times the bf16 and int8 mirrors' programs instead, at Dp = 256, 384, 768,
1536 and 3072 (2^20 rows up to 768, 2^19 past it, gaussian rows made on the card from a
seed; ~1% tombstones and a dead last tile): the bf16 mirror's light and heavy programs
and an int8 mirror's two streams (the engine's int8 program), with the bound rows the
certificate plan folds into each, l2, r1 = 32 with the block mins, 128 live queries of
the 512 bucket and 16 of the 64 bucket, each call as the engine makes it (the live
columns and a cached zero-query column).  Each is timed through the package's own
library (its launcher's rule, ``pick_route``) and through variants of ``sweep_min.cu``
(text edits of that rule, built under ``build/kernels/routes/``): ``narrow`` (16-query
tiles at every batch, the query resident where it fits), ``narrow_streamed`` (16-query
tiles, the query always streamed), ``no_two_stage`` (the 16-query tile streams its query
where a 3-stage ring leaves it no room, in place of a resident query beside 2 stages) and
``light_tile_64`` (the light program's tile at 64 queries).  A checkout whose source has no such launcher is timed through its own library
alone; a launch it refuses is written as "refused".  Beside each: the bound (the mirror,
the residual codes, the row terms, queries and outputs moved once over 3.35 TB/s, or the
live columns' passes as bf16 products over 989 TFLOP/s, whichever is longer) and the
one-pass product as one ``torch.matmul`` of bf16 operands (a yardstick).
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import types
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


ROUTE_DIMS = (256, 384, 768, 1536, 3072)
ROUTE_PROGRAMS = ("light", "heavy", "int8")
ROUTE_BATCHES = ((128, 512), (16, 64))   # (live queries, bucket)
# the lines of sweep_min.cu's pick_route that a variant turns off ("if (false)"): the wide
# tile past 16 queries, the narrow tile's resident query beside 3 stages and beside 2
_WIDE = "  if (Bq > 16 * NT_NARROW) {\n"
_RESIDENT = "  if (MmaShape<MT, TWO_PASS, RESID, NT_NARROW, NSTAGE, false>::smem(D) <= SMEM_MAX)\n"
_TWO_STAGE = ("  if (!IS_F32<MT> && MmaShape<MT, TWO_PASS, RESID, NT_NARROW, 2, false>::smem(D) "
              "<= SMEM_MAX)\n")
_LIGHT_TILE = "RESID || IS_F32<MT>) ? 4 : 8;"
# variant: (the lines it turns off, the light program's tile in n-tiles of a warp)
ROUTE_VARIANTS = {"narrow": ((_WIDE,), 8), "narrow_streamed": ((_WIDE, _RESIDENT, _TWO_STAGE), 8),
                  "no_two_stage": ((_TWO_STAGE,), 8), "light_tile_64": ((), 4)}


def _route_libraries(_kernels):
    """{variant: mlvdb_sweep_min of a build of sweep_min.cu taking that route}; empty
    where the source has no such rule to edit (an older checkout)."""
    src = (_kernels._CSRC / "sweep_min.cu").read_text()
    if any(src.count(line) != 1 for line in (_WIDE, _RESIDENT, _TWO_STAGE, _LIGHT_TILE)):
        return {}
    out = _kernels.BUILD_DIR / "routes"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (off, nt_light) in ROUTE_VARIANTS.items():
        text = src.replace(_LIGHT_TILE, _LIGHT_TILE.replace("8;", f"{nt_light};"))
        for line in off:
            text = text.replace(line, line[:line.index("(")] + ("(false) {\n" if line.endswith(
                "{\n") else "(false)\n"))
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_kernels._nvcc(), *_kernels._ARCH, "-I", str(_kernels._CSRC), "-Xcompiler", "-fPIC",
             "-shared", "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = _kernels.library().mlvdb_sweep_min
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}: {log}")
        fn = ctypes.CDLL(str(out / f"{name}.so")).mlvdb_sweep_min
        fn.argtypes, fn.restype = base.argtypes, base.restype
        fns[name] = fn
    return fns


def _route_operands(T, data, program, live, bucket, gen):
    """B1/B3's operands for ``program`` over ``data`` [n, d] f32 on the card, as the
    certified l2 search builds them (see tests/test_torch_gpu.py's _sweep_operands)."""
    n, d = data.shape
    dev = data.device
    q = torch.zeros((bucket, d), device=dev)
    q[:live] = torch.randn((live, d), generator=gen, device=dev)
    valid = torch.rand(n, generator=gen, device=dev) > 0.01
    valid[-T.SWEEP_TILE:] = False
    light, int8 = program == "light", program == "int8"
    if int8:
        mirror, s, z, s2, e2, e1 = T.quantize_int8_resid_rows(data)
    else:
        (z, s, e2, e1), s2 = T.quantize_resid_rows(data), None
        mirror = data.to(torch.bfloat16)
    wb = ("err1", "sqn_sqrt") if light else ("sweep_err", "err1")
    prep = T._prep_terms(valid, (data * data).sum(-1), n, s, e2, e1, cap=n, metric="l2",
                         masked=True, use_resid=not light, wb_sources=wb, rscale2=s2,
                         int8_sweep=int8)
    qh, qres, qres_f32 = T._fold_query(q, "l2", light, mirror.dtype)
    qe = torch.stack([torch.linalg.vector_norm(q, dim=1) * 2.0,
                      torch.linalg.vector_norm(qres_f32, dim=1)], 1).contiguous()
    args = (qh.contiguous(), qres, mirror, None if light else z, prep["rscale_row"],
            prep["scale_row"], prep["bias_row"])
    return args, dict(qe=qe, eb_rows=prep["eb_rows"], r1=32, emit_block_mins=True,
                      n_live=live, zero_cache={})


def _route_bound_ms(T, a, kw):
    """The live call's bound: bytes moved once over the HBM rate, or its bf16 passes
    (qh.m, qres.m, qh.resid) over the bf16 peak, whichever is longer."""
    outs = T._window_mins_t(*a, **kw)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*a, kw["qe"], *kw["eb_rows"], *outs) if t is not None)
    cap, dim = a[2].shape
    passes = 1 + (a[1] is not None) + (a[3] is not None)
    ops = 2.0 * cap * dim * T._live_columns(a[0].shape[0], kw["n_live"]) * passes
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def routes(out) -> None:
    """``--routes``: see the module's note."""
    from mlvectordb_tpu_torch.ops import _kernels
    from mlvectordb_tpu_torch.ops import fused_knn_t as T

    fns = _route_libraries(_kernels)
    out["variants"] = sorted(fns)
    own = _kernels.library
    for d in ROUTE_DIMS:
        n = 1 << (20 if d <= 768 else 19)
        gen = torch.Generator(device="cuda").manual_seed(d)
        data = torch.randn((n, d), generator=gen, device="cuda")
        for program in ROUTE_PROGRAMS:
            for live, bucket in ROUTE_BATCHES:
                a, kw = _route_operands(T, data, program, live, bucket, gen)
                key = f"{program}_dp{d}_b{live}"
                for name, fn in [("rule", None), *fns.items()]:
                    if fn is not None:
                        lib = types.SimpleNamespace(mlvdb_sweep_min=fn)
                        _kernels.library = lambda lib=lib: lib
                    try:
                        out[f"{key}_{name}_ms"] = _time_ms(lambda: T._window_mins_t(*a, **kw))
                    except RuntimeError as e:
                        out[f"{key}_{name}_ms"] = f"refused: {e}"
                    finally:
                        _kernels.library = own
                try:
                    out[f"{key}_bound_ms"], out[f"{key}_bound_by"] = _route_bound_ms(T, a, kw)
                except RuntimeError as e:
                    out[f"{key}_bound_ms"] = f"refused: {e}"
                m16 = a[2] if a[2].dtype == torch.bfloat16 else a[2].to(torch.bfloat16)
                out[f"{key}_matmul_ms"] = _time_ms(lambda: torch.matmul(m16, a[0][:live].T))
                del a, kw, m16
                torch.cuda.empty_cache()
        del data
        torch.cuda.empty_cache()


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
    if "--routes" in sys.argv[1:]:
        routes(out)
        print(json.dumps(out))
        return 0
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
