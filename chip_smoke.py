#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mlvectordb_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Builds the hand-written window-min kernels from csrc/ with nvcc (into build/kernels/),
then, printing one line per phase:
  1. device: the card's name and power limit;
  2. each kernel against its plain torch version on the card (l2/ip/cosine,
     N = 65,536 and 1,048,576, D = 128, B = 512, r1 in {8, 32});
  3. the default exact-kNN serving path at SIFT-1M shape through QueryProcessor:
     bulk_load of 1,048,576 x 128 f32, find_similar_batch (l2 at B=128, ip and cosine
     at B=16), delete of 1,000 ids and search again, each held to set-exact
     recall@10 = 1.0 against a float64 numpy oracle, plus the launch counts showing
     which kernels served it and the one-h2d/one-d2h transfer rule;
  4. times on the card (CUDA events; informative only).
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
from mlvectordb_tpu_torch.ops import _kernels, fused_knn
from mlvectordb_tpu_torch.ops.distances import MASKED

N, D, K, B = 1 << 20, 128, 10, 128
SEED = 42
KERNEL_SRC = "mlvectordb_tpu_torch/csrc/window_min.cu"


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


def _oracle_sets(db64, q, metric, dead=None, k=K):
    """Top-k row sets of a float64 brute force (rows in ``dead`` excluded)."""
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
    return [set(r.tolist()) for r in np.argpartition(d, k, axis=1)[:, :k]]


def _check_recall(results, want_rows, ids, label):
    want = [{ids[i] for i in rows} for rows in want_rows]
    hits = sum(len({r["id"] for r in rs} & w) for rs, w in zip(results, want))
    recall = hits / (len(want) * K)
    exact = all(len(rs) == K for rs in results)
    print(f"  {label}: recall@10 = {recall} over {len(want)} queries")
    if recall != 1.0 or not exact:
        raise AssertionError(f"{label}: recall@10 = {recall}, result lengths ok: {exact}")


def check_kernels(db_np):
    """Phase 2: each kernel against its plain version on the card.  Returns max |err|."""
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

    # ---- 2. kernels against their plain versions ---------------------------------
    print("phase 2 kernels vs plain on the card")
    worst = check_kernels(db_np)

    # ---- 3. the main path at SIFT-1M shape ------------------------------------------
    print(f"phase 3 main path: QueryProcessor at {N:,} x {D} f32")
    dev = torch.device("cuda")
    db64 = db_np.astype(np.float64)
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
    _check_recall(res, _oracle_sets(db64, q_np, "l2"), ids, "l2 B=128")
    for metric in ("ip", "cosine"):
        res = qp.find_similar_batch([VectorDTO(v) for v in q_np[:16]], K, "sift", metric)
        _check_recall(res, _oracle_sets(db64, q_np[:16], metric), ids, f"{metric} B=16")
    wall_fast = _engine_wall(qp, q_np)
    split_fast = _engine_split(qp, q_np)
    fast_after_search = fused_knn._window_mins_fast.launches

    # delete 1,000 rows, among them each query's current nearest neighbour (under the
    # 0.2 compaction threshold, so the namespace keeps its tombstones: masked kernel)
    l2_sets = _oracle_sets(db64, q_np, "l2", k=1)
    dead = sorted({next(iter(s)) for s in l2_sets})
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
        _check_recall(res, _oracle_sets(db64, q_np[:nq], metric, dead=dead), ids,
                      f"{metric} B={nq} after delete")
    self_hit = qp.find_similar(VectorDTO(db_np[self_row]), 1, "sift", "l2")
    print(f"  self query (row {self_row}): score {self_hit[0]['score']}")
    if self_hit[0]["id"] != ids[self_row] or not self_hit[0]["score"] < 1e-5:
        raise AssertionError(f"stored row {self_row} queried as itself returned {self_hit[:1]}")

    launches = {"fast": fused_knn._window_mins_fast.launches,
                "masked": fused_knn._window_mins_masked.launches}
    print(f"  kernel launches on the main path: fast_launches={launches['fast']} "
          f"masked_launches={launches['masked']} (fast before delete: {fast_after_search})")
    if launches["fast"] < 1 or launches["masked"] < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    # ---- 4. times (informative) -------------------------------------------------------
    print(f"phase 4 times on {gpu} (CUDA events, mean of 10 after a warm call)")
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
    flop = 2.0 * N * 512 * D
    for name, ms in times.items():
        extra = f", {flop / ms / 1e9:.1f} TFLOP/s" if name in ("fast", "masked") else ""
        print(f"  {name}: {ms:.4f} ms{extra}")
    print(f"  engine wall runs (ms), B={B} l2: fast path {wall_fast}, masked path "
          f"{wall_masked} on {gpu}")
    print(f"  engine split, median ms (host clock): fast path {split_fast}, masked path "
          f"{split_masked}")

    record = {"kernels": [
        {"name": "window_min_fast", "route": "cuda", "source": KERNEL_SRC,
         "replaces": "mlvectordb_tpu/ops/pallas_knn.py:102", "launches": launches["fast"],
         "max_abs_err": worst["fast"], "ms": times["fast"], "plain_ms": times["fast_plain"]},
        {"name": "window_min_masked", "route": "cuda", "source": KERNEL_SRC,
         "replaces": "mlvectordb_tpu/ops/pallas_knn.py:131", "launches": launches["masked"],
         "max_abs_err": worst["masked"], "ms": times["masked"],
         "plain_ms": times["masked_plain"]},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
