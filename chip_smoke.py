#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mlvectordb_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from csrc/ with nvcc (into build/kernels/), then, printing
one line per phase:
  1. device: the card's name and power limit;
  2. the row-major window-min kernels against their plain torch versions on the card
     (l2/ip/cosine, N = 65,536 and 1,048,576, D = 128, B = 512, r1 in {8, 32});
  3. the default exact-kNN serving path at SIFT-1M shape through QueryProcessor:
     bulk_load of 1,048,576 x 128 f32, find_similar_batch (l2 at B=128, ip and cosine
     at B=16), delete of 1,000 ids and search again, each held to set-exact
     recall@10 = 1.0 against a float64 numpy oracle, plus the launch counts showing
     which kernels served it and the one-h2d/one-d2h transfer rule;
  4. the certified sweep kernels against their plain versions on the card: the sweep
     window-min kernel, light and heavy, l2/ip/cosine, N = 65,536 and 1,048,576,
     B = 512, ~1% tombstones in the bias row; the gather-score rescan at the main path's
     B = 512, 32 windows of 32 rows;
  5. the certified sweep path (EngineConfig(sweep_dtype="bfloat16")) at the same shape
     and with the same checks as phase 3, the light program serving at tier 0; then a
     clustered namespace of 131,072 rows where the light proof fails, the exact scan
     serves, the namespace flips to the heavy program, and both batches match the
     oracle's k-distances; the launch counts of the sweep kernels;
  6. times on the card (CUDA events; informative only).
Any failure raises, so the process exits non-zero.  The last two lines are the kernels'
JSON record and {"ok": true, "device": {...}}.  Needs no network and imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.ops import _kernels, fused_knn, fused_knn_t
from mlvectordb_tpu_torch.ops.distances import MASKED

N, D, K, B = 1 << 20, 128, 10, 128
SEED = 42
CSRC = "mlvectordb_tpu_torch/csrc/"
SWEEP = EngineConfig(sweep_dtype="bfloat16")


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int = 10) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls after a warm one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _engine_wall(qp, q_np, runs: int = 5):
    """Host wall times (ms) of find_similar_batch at B=128, l2, k=10: distinct queries per
    run, so the result cache cannot serve them; each run ends in its device->host copy."""
    wall = []
    for i in range(runs):
        qs = [VectorDTO(v) for v in q_np + np.float32(i + 1) * np.float32(1e-3)]
        t0 = time.perf_counter()
        qp.find_similar_batch(qs, K, "sift", "l2")
        wall.append((time.perf_counter() - t0) * 1e3)
    return wall


def _engine_split(qp, q_np, runs: int = 5):
    """Median host ms of the three parts of find_similar_batch at B=128, l2, k=10:
    stacking the query DTOs, _raw_search (h2d, kernel, selection and rescan, d2h) and
    hydration of the result dicts."""
    parts = {"stack": [], "raw_search": [], "hydrate": []}
    for i in range(runs):
        qs = [VectorDTO(v) for v in q_np + np.float32(i + 11) * np.float32(1e-3)]
        t0 = time.perf_counter()
        q = np.stack([np.asarray(x.values, np.float32).reshape(-1) for x in qs])
        t1 = time.perf_counter()
        dist, slots, _, tables = qp._raw_search(q, "sift", K, "l2")
        t2 = time.perf_counter()
        qp._hydrate_batch(qp._to_user_score(dist, "l2"), dist, slots, tables)
        t3 = time.perf_counter()
        for name, ms in zip(parts, ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3)):
            parts[name].append(ms)
    return {name: statistics.median(v) for name, v in parts.items()}


def _oracle_dists(db64, q, metric, dead=None):
    """[nq, n] float64 brute-force distances (rows in ``dead`` at +inf)."""
    q64 = q.astype(np.float64)
    dots = q64 @ db64.T
    sq = (db64 * db64).sum(-1)
    if metric == "l2":
        d = sq[None, :] - 2.0 * dots + (q64 * q64).sum(-1)[:, None]
    elif metric == "ip":
        d = 1.0 - dots
    else:
        d = 1.0 - dots / np.sqrt(np.maximum(sq[None, :] * (q64 * q64).sum(-1)[:, None], 1e-30))
    if dead is not None:
        d[:, dead] = np.inf
    return d


class Oracle:
    """Top-k row sets of the float64 brute force, computed once per (metric, batch,
    deletes) and shared by the row-major and the sweep phases (same corpus, same queries)."""

    def __init__(self, db64, q_np):
        self.db64, self.q_np, self.cache = db64, q_np, {}

    def sets(self, metric, nq, dead=None, k=K):
        key = (metric, nq, dead is not None, k)
        if key not in self.cache:
            d = _oracle_dists(self.db64, self.q_np[:nq], metric, dead)
            self.cache[key] = [set(r.tolist()) for r in np.argpartition(d, k, axis=1)[:, :k]]
        return self.cache[key]


def _check_recall(results, want_rows, ids, label):
    want = [{ids[i] for i in rows} for rows in want_rows]
    hits = sum(len({r["id"] for r in rs} & w) for rs, w in zip(results, want))
    recall = hits / (len(want) * K)
    exact = all(len(rs) == K for rs in results)
    print(f"  {label}: recall@10 = {recall} over {len(want)} queries")
    if recall != 1.0 or not exact:
        raise AssertionError(f"{label}: recall@10 = {recall}, result lengths ok: {exact}")


def check_kernels(db_np):
    """Phase 2: each row-major kernel against its plain version on the card.  Returns
    max |err|."""
    masked_value = float(MASKED)
    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    worst = {"fast": 0.0, "masked": 0.0}
    for n in (65536, N):
        data = torch.from_numpy(db_np[:n]).to(dev)
        q = torch.from_numpy(rng.standard_normal((512, D), dtype=np.float32)).to(dev)
        qt, qn = q.T.contiguous(), (q * q).sum(-1)[None, :].contiguous()
        hw = n - fused_knn.DB_TILE - 1234
        valid = torch.from_numpy(rng.random(n) > 0.01).to(dev)   # ~1% tombstones
        valid[-fused_knn.DB_TILE:] = False                         # fully masked windows
        maskadd = torch.where(valid, 0.0, masked_value)
        for r1 in (8, 32):
            for metric in ("l2", "ip", "cosine"):
                kw = dict(metric=metric, db_tile=fused_knn.DB_TILE, r1=r1)
                bias = ((data * data).sum(-1) + maskadd if metric == "l2" else maskadd)
                bias = bias[:, None].contiguous()
                pairs = {
                    "fast": (fused_knn._window_mins_fast(data, qt, qn, hw, **kw),
                             fused_knn._window_mins_fast_ref(data, qt, qn, hw, **kw)),
                    "masked": (fused_knn._window_mins_masked(data, qt, qn, bias, **kw),
                               fused_knn._window_mins_masked_ref(data, qt, qn, bias, **kw)),
                }
                torch.cuda.synchronize()
                for name, (got, want) in pairs.items():
                    dead = want == masked_value
                    if not torch.equal(got[dead], want[dead]) or not dead.any():
                        raise AssertionError(f"{name} n={n} r1={r1} {metric}: masked windows differ")
                    err = (got[~dead] - want[~dead]).abs()
                    bound = 1e-5 * want[~dead].abs() + 1e-3
                    if not bool((err <= bound).all()):
                        raise AssertionError(
                            f"{name} n={n} r1={r1} {metric}: max |err| {err.max().item()}")
                    worst[name] = max(worst[name], err.max().item())
        del data, q, qt, qn, valid, maskadd, bias, pairs
    print(f"  max |kernel - plain| on live windows: fast {worst['fast']}, masked "
          f"{worst['masked']} (bound 1e-5*|plain| + 1e-3; masked windows exactly 3e38)")
    return worst


def _sweep_operands(data, q, valid, metric, heavy):
    """Kernel B1's operands as the certified search builds them (fused_knn_t._fused_t):
    the folded query, the bias/scale rows of ``valid`` and the two certificate bound rows
    with their per-query scales.  Returns (args, kwargs, per-query slack)."""
    n = data.shape[0]
    z, s, e2, e1 = fused_knn_t.quantize_resid_rows(data)
    sources = ("sweep_err", "err1") if heavy else ("err1", "sqn_sqrt")
    prep = fused_knn_t._prep_terms(valid, (data * data).sum(-1), n, s, e2, e1, cap=n,
                                   metric=metric, masked=True, use_resid=heavy,
                                   wb_sources=sources)
    qh, qres, qres_f32 = fused_knn_t._fold_query(q, metric, light=not heavy)
    qh_l2 = torch.linalg.vector_norm(q, dim=1) * (2.0 if metric == "l2" else 1.0)
    qe = torch.stack([qh_l2, torch.linalg.vector_norm(qres_f32, dim=1)], 1).contiguous()
    args = (qh, qres, data.to(torch.bfloat16), z if heavy else None, s if heavy else None,
            prep["scale_row"], prep["bias_row"])
    kw = dict(r1=32, emit_block_mins=True, qe=qe, eb_rows=prep["eb_rows"])
    slack = D * 2.0 ** -22 * qh_l2 * (1.0 if metric == "cosine" else prep["maxd"])
    return args, kw, slack


def check_sweep_kernels(db_np):
    """Phase 4: the sweep window-min kernel (light and heavy, l2/ip/cosine, at r1 = 32 with
    the block mins, as the k=10 path runs it) and the gather-score kernel against their
    plain versions.  Live windows within the certificate's accumulation slack
    Dp * 2^-22 * |qh| * maxd per query; fully masked windows exactly 3e38; the rescan's
    dots and norms within Dp * 2^-24 * (|q| |row| + |row|^2).  Returns max |err|."""
    rng = np.random.default_rng(SEED + 2)
    dev = torch.device("cuda")
    worst = {"light": 0.0, "heavy": 0.0, "gather": 0.0}
    for n in (65536, N):
        data = torch.from_numpy(db_np[:n]).to(dev)
        q = torch.from_numpy(rng.standard_normal((512, D), dtype=np.float32)).to(dev)
        valid = torch.from_numpy(rng.random(n) > 0.01).to(dev)   # ~1% tombstones
        valid[-fused_knn_t.SWEEP_TILE:] = False                    # a fully masked tile
        for heavy in (False, True):
            for metric in ("l2", "ip", "cosine"):
                args, kw, slack = _sweep_operands(data, q, valid, metric, heavy)
                got = fused_knn_t._window_mins_t(*args, **kw)
                want = fused_knn_t._window_mins_t_ref(*args, **kw)
                torch.cuda.synchronize()
                for g, w, sl in zip(got, want, (slack[None, :, None], slack[None, :])):
                    dead = w == float(MASKED)
                    if not torch.equal(g[dead], w[dead]) or not dead.any():
                        raise AssertionError(f"sweep n={n} heavy={heavy} {metric}: masked "
                                             "windows differ")
                    err = torch.where(dead, torch.zeros_like(g), (g - w).abs())
                    if not bool((err <= sl).all()):
                        raise AssertionError(f"sweep n={n} heavy={heavy} {metric}: |err| / "
                                             f"slack {float((err / sl).max())}")
                    name = "heavy" if heavy else "light"
                    worst[name] = max(worst[name], float(err.max()))
                del args, kw, got, want
        del data, q, valid
    data = torch.from_numpy(db_np).to(dev)
    q = torch.from_numpy(rng.standard_normal((512, D), dtype=np.float32)).to(dev)
    f = torch.sort(torch.randint(0, N // 32, (512, 32), device=dev), 1).values.to(torch.int32)
    dots, sqn = fused_knn_t._gather_score(q, data, f, r1=32)
    want_dots, want_sqn = fused_knn_t._gather_score_ref(q, data, f, r1=32)
    torch.cuda.synchronize()
    bound = D * 2.0 ** -24 * (torch.linalg.vector_norm(q, dim=1)[:, None] * want_sqn.sqrt()
                              + want_sqn)
    for got, want in ((dots, want_dots), (sqn, want_sqn)):
        err = (got - want).abs()
        if not bool((err <= bound).all()):
            raise AssertionError(f"gather_score: |err| / bound {float((err / bound).max())}")
        worst["gather"] = max(worst["gather"], float(err.max()))
    print(f"  max |kernel - plain|: sweep light {worst['light']}, sweep heavy "
          f"{worst['heavy']} (live windows, bound Dp*2^-22*|qh|*maxd; masked exactly 3e38); "
          f"gather_score {worst['gather']} (bound Dp*2^-24*(|q||row| + |row|^2))")
    return worst


def _check_kdists(results, db64, q, label):
    """Sorted returned l2 distances against the float64 oracle's k smallest, within the
    f32 cancellation of the expansion qn + sqn - 2 q.x (16 ulps of qn + max sqn), since
    ties on clustered data make id sets ambiguous."""
    want = np.sort(_oracle_dists(db64, q, "l2"), axis=1)[:, :K]
    got = np.sort(np.array([[r["score"] for r in rs] for rs in results]), axis=1)
    tol = 16 * 2.0 ** -24 * ((q.astype(np.float64) ** 2).sum(-1) + (db64 ** 2).sum(-1).max())
    err = np.abs(got - want)
    print(f"  {label}: max |k-dist - oracle| = {err.max():.3e} (bound {tol.max():.3e})")
    if got.shape != want.shape or not (err <= tol[:, None]).all():
        raise AssertionError(f"{label}: k-distances differ from the oracle")


def run_sweep_path(db_np, q_np, oracle, dead, self_row):
    """Phase 5: the certified sweep path through QueryProcessor.  Returns the processor and
    the clustered namespace's arrays (for the times)."""
    dev = torch.device("cuda")
    qp = QueryProcessor(SWEEP, device=dev)
    t0 = time.perf_counter()
    ids = qp.bulk_load(db_np, "sift")
    torch.cuda.synchronize()
    ns = qp.storage.namespace("sift")
    print(f"  bulk_load: {len(ids)} rows in {time.perf_counter() - t0:.2f} s, capacity "
          f"{ns.capacity}, device bytes {ns.nbytes:,}")
    x0 = dict(qp.transfer_counts)
    res = qp.find_similar_batch([VectorDTO(v) for v in q_np], K, "sift", "l2")
    xfer = (qp.transfer_counts["h2d"] - x0["h2d"], qp.transfer_counts["d2h"] - x0["d2h"])
    print(f"  transfers per search (h2d, d2h): {xfer}, tiers {qp.cert_tier_counts('sift')}")
    if xfer != (1, 1):
        raise AssertionError(f"transfer rule broken: {xfer}")
    _check_recall(res, oracle.sets("l2", B), ids, "sweep l2 B=128")
    for metric in ("ip", "cosine"):
        res = qp.find_similar_batch([VectorDTO(v) for v in q_np[:16]], K, "sift", metric)
        _check_recall(res, oracle.sets(metric, 16), ids, f"sweep {metric} B=16")
    removed = qp.delete([ids[i] for i in dead], "sift")
    if len(removed) != 1000 or ns.device_state().live_count == ns.device_state().high_water:
        raise AssertionError("delete did not leave tombstones")
    dead_ids = {ids[i] for i in dead}
    for metric, nq in (("l2", B), ("ip", 16), ("cosine", 16)):
        res = qp.find_similar_batch([VectorDTO(v) for v in q_np[:nq]], K, "sift", metric)
        if any(r["id"] in dead_ids for rs in res for r in rs):
            raise AssertionError(f"sweep {metric}: a deleted id was returned")
        _check_recall(res, oracle.sets(metric, nq, dead), ids,
                      f"sweep {metric} B={nq} after delete")
    tiers = qp.cert_tier_counts("sift")
    print(f"  certificate tiers, gaussian namespace: {tiers}")
    if tiers != {"light_fast": 6}:
        raise AssertionError(f"the light program did not serve every batch at tier 0: {tiers}")
    self_hit = qp.find_similar(VectorDTO(db_np[self_row]), 1, "sift", "l2")
    bound = 16 * 2.0 ** -24 * 2 * float((db_np[self_row].astype(np.float64) ** 2).sum())
    print(f"  self query (row {self_row}): score {self_hit[0]['score']} (f32 expansion "
          f"bound {bound:.3e})")
    if self_hit[0]["id"] != ids[self_row] or not self_hit[0]["score"] <= bound:
        raise AssertionError(f"stored row {self_row} queried as itself returned {self_hit[:1]}")

    # clustered: neighbour gaps far below the light program's bf16 band
    rng = np.random.default_rng(SEED + 3)
    centres = rng.standard_normal((8, D)).astype(np.float32) * 0.05
    xc = (centres[rng.integers(0, 8, 131072)]
          + rng.standard_normal((131072, D)).astype(np.float32) * 1e-3).astype(np.float32)
    qc = (centres[rng.integers(0, 8, 2 * B)]
          + rng.standard_normal((2 * B, D)).astype(np.float32) * 1e-3).astype(np.float32)
    xc64 = xc.astype(np.float64)
    qp.bulk_load(xc, "clustered")
    for i, label in enumerate(("first batch (light)", "second batch (after the flip)")):
        qb = qc[i * B:(i + 1) * B]
        before = qp.cert_tier_counts("clustered")
        x0 = dict(qp.transfer_counts)
        res = qp.find_similar_batch([VectorDTO(v) for v in qb], K, "clustered", "l2")
        after = qp.cert_tier_counts("clustered")
        served = [t for t in after if after[t] != before.get(t, 0)]
        xfer = (qp.transfer_counts["h2d"] - x0["h2d"], qp.transfer_counts["d2h"] - x0["d2h"])
        print(f"  clustered {label}: tier {served}, transfers {xfer}, mode "
              f"{qp._cert_mode.get(('clustered', 'l2', False), 'light')}")
        _check_kdists(res, xc64, qb, f"clustered {label}")
        if i == 0 and (served != ["light_exact_scan"]
                       or qp._cert_mode.get(("clustered", "l2", False)) != "heavy"):
            raise AssertionError("the light program did not escalate and flip to heavy")
        if i == 1 and any(t.startswith("light_") for t in served):
            raise AssertionError("the second clustered batch did not run the heavy program")
    return qp


def _capture(fn_name, call):
    """The positional and keyword arguments of the first call of fused_knn_t.<fn_name>
    made by ``call()``: the kernel's operands at the main path's shapes."""
    real = getattr(fused_knn_t, fn_name)
    seen = []

    def spy(*a, **kw):
        if not seen:
            seen.append((a, kw))
        return real(*a, **kw)

    # the wrapper counts its launches on the module attribute, which is the spy meanwhile
    spy.__dict__.update(real.__dict__)
    setattr(fused_knn_t, fn_name, spy)
    try:
        call()
    finally:
        setattr(fused_knn_t, fn_name, real)
        real.__dict__.update(spy.__dict__)
    return seen[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA GPU",
              file=sys.stderr)
        return 2

    # ---- 1. device ------------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    gpu = _gpu_line()
    print(f"phase 1 device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}"
          " | nvidia-smi name, power.limit:")
    print(gpu)
    t0 = time.perf_counter()
    lib = _kernels.build()
    print(f"  kernels built: {lib.name} in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    db_np = rng.standard_normal((N, D), dtype=np.float32)
    q_np = rng.standard_normal((B, D), dtype=np.float32)
    db64 = db_np.astype(np.float64)
    oracle = Oracle(db64, q_np)

    # ---- 2. row-major kernels against their plain versions ---------------------------
    print("phase 2 row-major kernels vs plain on the card")
    worst = check_kernels(db_np)

    # ---- 3. the row-major main path at SIFT-1M shape ---------------------------------
    print(f"phase 3 row-major path: QueryProcessor at {N:,} x {D} f32")
    dev = torch.device("cuda")
    fused_knn._window_mins_fast.launches = 0
    fused_knn._window_mins_masked.launches = 0

    qp = QueryProcessor(EngineConfig(), device=dev)
    t0 = time.perf_counter()
    ids = qp.bulk_load(db_np, "sift")
    torch.cuda.synchronize()
    print(f"  bulk_load: {len(ids)} rows in {time.perf_counter() - t0:.2f} s, capacity "
          f"{qp.storage.namespace('sift').capacity}")
    x0 = dict(qp.transfer_counts)
    res = qp.find_similar_batch([VectorDTO(v) for v in q_np], K, "sift", "l2")
    xfer = (qp.transfer_counts["h2d"] - x0["h2d"], qp.transfer_counts["d2h"] - x0["d2h"])
    print(f"  transfers per search (h2d, d2h): {xfer}")
    if xfer != (1, 1):
        raise AssertionError(f"transfer rule broken: {xfer}")
    _check_recall(res, oracle.sets("l2", B), ids, "l2 B=128")
    for metric in ("ip", "cosine"):
        res = qp.find_similar_batch([VectorDTO(v) for v in q_np[:16]], K, "sift", metric)
        _check_recall(res, oracle.sets(metric, 16), ids, f"{metric} B=16")
    wall_fast = _engine_wall(qp, q_np)
    split_fast = _engine_split(qp, q_np)
    fast_after_search = fused_knn._window_mins_fast.launches

    # delete 1,000 rows, among them each query's current nearest neighbour (under the
    # 0.2 compaction threshold, so the namespace keeps its tombstones: masked kernel)
    dead = sorted({next(iter(s)) for s in oracle.sets("l2", B, k=1)})
    others = rng.choice(np.setdiff1d(np.arange(N), dead), 1000 - len(dead), replace=False)
    dead = np.asarray(sorted(dead + others.tolist()))
    self_row = int(np.setdiff1d(np.arange(1234, 2234), dead)[0])
    removed = qp.delete([ids[i] for i in dead], "sift")
    ns = qp.storage.namespace("sift")
    print(f"  deleted {len(removed)} ids; tombstones {ns._tombstones}, capacity {ns.capacity}")
    if len(removed) != 1000 or ns.device_state().live_count == ns.device_state().high_water:
        raise AssertionError("delete did not leave tombstones")
    dead_ids = {ids[i] for i in dead}
    for metric, nq in (("l2", B), ("ip", 16), ("cosine", 16)):
        res = qp.find_similar_batch([VectorDTO(v) for v in q_np[:nq]], K, "sift", metric)
        if any(r["id"] in dead_ids for rs in res for r in rs):
            raise AssertionError(f"{metric}: a deleted id was returned")
        _check_recall(res, oracle.sets(metric, nq, dead), ids, f"{metric} B={nq} after delete")
    self_hit = qp.find_similar(VectorDTO(db_np[self_row]), 1, "sift", "l2")
    print(f"  self query (row {self_row}): score {self_hit[0]['score']}")
    if self_hit[0]["id"] != ids[self_row] or not self_hit[0]["score"] < 1e-5:
        raise AssertionError(f"stored row {self_row} queried as itself returned {self_hit[:1]}")

    launches = {"fast": fused_knn._window_mins_fast.launches,
                "masked": fused_knn._window_mins_masked.launches}
    print(f"  kernel launches on the row-major path: fast_launches={launches['fast']} "
          f"masked_launches={launches['masked']} (fast before delete: {fast_after_search})")
    if launches["fast"] < 1 or launches["masked"] < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    # ---- 4. sweep kernels against their plain versions ---------------------------------
    print("phase 4 certified sweep kernels vs plain on the card")
    worst.update(check_sweep_kernels(db_np))

    # ---- 5. the certified sweep path ----------------------------------------------------
    print(f"phase 5 certified sweep path: QueryProcessor(sweep_dtype='bfloat16') at {N:,} x {D}")
    fused_knn_t._window_mins_t.launches = 0
    fused_knn_t._window_mins_t.launches_heavy = 0
    fused_knn_t._gather_score.launches = 0
    qps = run_sweep_path(db_np, q_np, oracle, dead, self_row)
    launches["sweep"] = fused_knn_t._window_mins_t.launches
    launches["sweep_heavy"] = fused_knn_t._window_mins_t.launches_heavy
    launches["gather"] = fused_knn_t._gather_score.launches
    print(f"  kernel launches on the sweep path: sweep_min={launches['sweep']} (heavy "
          f"{launches['sweep_heavy']}, light {launches['sweep'] - launches['sweep_heavy']}) "
          f"gather_score={launches['gather']}")
    if (launches["sweep_heavy"] < 1 or launches["sweep"] - launches["sweep_heavy"] < 1
            or launches["gather"] < 1):
        raise AssertionError(f"a kernel of the sweep path never launched: {launches}")

    # ---- 6. times (informative) -------------------------------------------------------
    print(f"phase 6 times on {gpu} (CUDA events, mean of 10 after a warm call)")
    state = ns.device_state()
    data = state.data
    q512 = torch.from_numpy(rng.standard_normal((512, D), dtype=np.float32)).to(dev)
    qt, qn = q512.T.contiguous(), (q512 * q512).sum(-1)[None, :].contiguous()
    maskadd = torch.where(state.valid, 0.0, float(MASKED))
    bias = (state.sq_norms + maskadd)[:, None].contiguous()
    kw = dict(metric="l2", db_tile=fused_knn.DB_TILE, r1=fused_knn._pick_r1(512, N, 16))
    times = {
        "fast": _time_ms(lambda: fused_knn._window_mins_fast(data, qt, qn, N, **kw)),
        "fast_plain": _time_ms(lambda: fused_knn._window_mins_fast_ref(data, qt, qn, N, **kw)),
        "masked": _time_ms(lambda: fused_knn._window_mins_masked(data, qt, qn, bias, **kw)),
        "masked_plain": _time_ms(
            lambda: fused_knn._window_mins_masked_ref(data, qt, qn, bias, **kw)),
    }
    # one search at B=128 padded to the 512 bucket, as the engine runs it (k bucket 16)
    q_pad = torch.zeros((512, D), device=dev)
    q_pad[:B] = torch.from_numpy(q_np).to(dev)
    times["exact_knn_fused_masked"] = _time_ms(lambda: fused_knn.exact_knn_fused(
        q_pad, data, state.valid, state.sq_norms, k=16, metric="l2", live_prefix=None))
    times["exact_knn_fused_fast"] = _time_ms(lambda: fused_knn.exact_knn_fused(
        q_pad, data, state.valid, state.sq_norms, k=16, metric="l2", live_prefix=N))
    wall_masked = _engine_wall(qp, q_np)
    split_masked = _engine_split(qp, q_np)
    times["engine_wall_fast_median"] = statistics.median(wall_fast)
    times["engine_wall_masked_median"] = statistics.median(wall_masked)

    # the sweep kernels at the operands the engine's l2 B=128 search gives them (bucket
    # 512, k bucket 16: r1 = 32, block mins, two bound rows), on the tombstoned namespace
    sst = qps.storage.namespace("sift").device_state()

    def sweep_search(light):
        return fused_knn_t.exact_knn_t(
            q_pad, sst.mirror, sst.data, sst.valid, sst.sq_norms, k=16, metric="l2",
            live_prefix=None, sweep_err=sst.sweep_err, resid=sst.sweep_resid,
            rscale=sst.sweep_rscale, err1=sst.sweep_err1, light=light,
            prep_cache=sst.prep_cache, report_tier=True)

    for light in (True, False):
        name = "sweep_light" if light else "sweep_heavy"
        a, k_ = _capture("_window_mins_t", lambda: sweep_search(light))
        times[name] = _time_ms(lambda: fused_knn_t._window_mins_t(*a, **k_))
        times[name + "_plain"] = _time_ms(lambda: fused_knn_t._window_mins_t_ref(*a, **k_))
        times["exact_knn_t_" + ("light" if light else "heavy")] = _time_ms(
            lambda: sweep_search(light))
    a, k_ = _capture("_gather_score", lambda: sweep_search(True))
    times["gather_score"] = _time_ms(lambda: fused_knn_t._gather_score(*a, **k_))
    times["gather_score_plain"] = _time_ms(lambda: fused_knn_t._gather_score_ref(*a, **k_))
    gather_rows = a[2].numel() * k_["r1"]
    wall_sweep = _engine_wall(qps, q_np)
    split_sweep = _engine_split(qps, q_np)
    times["engine_wall_sweep_masked_median"] = statistics.median(wall_sweep)

    flop = 2.0 * N * 512 * D
    for name, ms in times.items():
        extra = ""
        if name in ("fast", "masked", "sweep_light"):
            extra = f", {flop / ms / 1e9:.1f} TFLOP/s"
        elif name == "sweep_heavy":
            extra = f", {3 * flop / ms / 1e9:.1f} TFLOP/s"
        elif name == "gather_score":
            extra = f", {gather_rows * D * 4 / ms / 1e6:.1f} GB/s of gathered rows"
        print(f"  {name}: {ms:.4f} ms{extra}")
    print(f"  engine wall runs (ms), B={B} l2: fast path {wall_fast}, masked path "
          f"{wall_masked}, sweep path (tombstoned) {wall_sweep} on {gpu}")
    print(f"  engine split, median ms (host clock): fast path {split_fast}, masked path "
          f"{split_masked}, sweep path {split_sweep}")

    record = {"kernels": [
        {"name": "window_min_fast", "route": "cuda", "source": CSRC + "window_min.cu",
         "replaces": "mlvectordb_tpu/ops/pallas_knn.py:102", "launches": launches["fast"],
         "max_abs_err": worst["fast"], "ms": times["fast"], "plain_ms": times["fast_plain"]},
        {"name": "window_min_masked", "route": "cuda", "source": CSRC + "window_min.cu",
         "replaces": "mlvectordb_tpu/ops/pallas_knn.py:131", "launches": launches["masked"],
         "max_abs_err": worst["masked"], "ms": times["masked"],
         "plain_ms": times["masked_plain"]},
        {"name": "sweep_min", "route": "cuda", "source": CSRC + "sweep_min.cu",
         "replaces": "mlvectordb_tpu/ops/pallas_knn_t.py:221", "launches": launches["sweep"],
         "max_abs_err": max(worst["light"], worst["heavy"]), "ms": times["sweep_light"],
         "plain_ms": times["sweep_light_plain"],
         "launches_heavy": launches["sweep_heavy"], "heavy_ms": times["sweep_heavy"],
         "heavy_plain_ms": times["sweep_heavy_plain"]},
        {"name": "gather_score", "route": "cuda", "source": CSRC + "gather_score.cu",
         "replaces": "mlvectordb_tpu/ops/pallas_gather.py:33", "launches": launches["gather"],
         "max_abs_err": worst["gather"], "ms": times["gather_score"],
         "plain_ms": times["gather_score_plain"]},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
