"""One run of one cell: set-up, the measured window, the reference check, the metrics.

Set-up draws the rows, metadata and queries from the seed, loads the rows through the
program's ``bulk_load`` and warms the cell's own shapes with a few calls; ``setup_s``
runs from the process's start to the first timed call.  The window is the closed loop
of ``loop.py``; with a trace, a steady part of it is captured (``capture.py``).  After the
window the device peak is read, the program is freed, and the kept answers are judged
against the float64 reference (``judge.py``).
"""

from __future__ import annotations

import gc
import json
import time
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from . import data, judge, loop, reference, spec, system
from .capture import Capture, prime as capture_prime


def filter_spec(traffic: dict, n: int) -> Optional[dict]:
    """The traffic's metadata filter at its rate: ``{"field": f, "rate": r}`` admits
    the rows whose ``f`` is at least round(n * r), the last (1 - r) of the rows
    (VectorDBBench's filter rate r on its int64 ``id`` field)."""
    f = traffic.get("filter")
    if not f:
        return None
    return {f["field"]: {"$gte": int(round(n * f["rate"]))}}


def _delta(after: Dict, before: Dict) -> Dict:
    return {
        "stage": {k: (after["stage_ms"][k] - before["stage_ms"].get(k, 0.0),
                      after["stage_n"][k] - before["stage_n"].get(k, 0))
                  for k in after["stage_ms"]},
        "spans": {k: (v[0] - before["spans"].get(k, (0.0, 0))[0],
                      v[1] - before["spans"].get(k, (0.0, 0))[1])
                  for k, v in after["spans"].items()},
        "tiers": {k: v - before["tiers"].get(k, 0) for k, v in after["tiers"].items()},
        "h2d": after["h2d"] - before["h2d"],
        "d2h": after["d2h"] - before["d2h"],
        "settle_copies": after["settle_copies"] - before["settle_copies"],
    }


def prepare(cell: dict, seed: int, n_queries: int, device) -> SimpleNamespace:
    """Set-up: the inputs drawn from the seed (``n_queries`` in the pool), the program
    loaded through ``bulk_load``, the cell's shapes warmed."""
    dev = torch.device(device)
    cfg, trf = cell["config"], cell["traffic"]
    n, dim, metric = int(cfg["rows"]), int(cfg["dim"]), cfg["metric"]
    batch, k = int(trf["batch"]), int(trf["k"])
    if trf.get("loop") != "closed" or trf.get("queries") != "gaussian":
        raise ValueError("the generator sends gaussian queries from closed-loop clients")
    rows = data.host_array(seed, "rows", n, dim, dev)
    metas, columns = data.metadata(cfg.get("metadata"), n)
    fspec = filter_spec(trf, n)
    keep_rows = reference.filter_mask(columns, fspec, n) if fspec else None
    pool = data.host_array(seed, "queries", n_queries, dim, dev)
    warm = data.host_array(seed, "warmup", int(trf["warmup_calls"]) * batch, dim, dev)
    qp, ids = system.build(cfg, rows, metas, dev)

    def call(qs: np.ndarray) -> list:
        return qp.find_similar_batch(system.dtos(qs), top_k=k, namespace=system.NAMESPACE,
                                     metric=metric, filter=fspec)

    for j in range(int(trf["warmup_calls"])):
        call(warm[j * batch:(j + 1) * batch])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # every window starts from the same collector state: the load's objects collected once
    gc.collect()
    # the benchmark keeps no per-row Python objects of its own beside the program's, which
    # the program's garbage collections would walk: the judge reads the metadata columns
    del metas
    return SimpleNamespace(dev=dev, rows=rows, columns=columns, keep_rows=keep_rows,
                           fspec=fspec, pool=pool, qp=qp, ids=ids, call=call)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             log=print) -> Dict:
    """Run ``cell`` once; returns the result line's fields, ``checks`` last.  ``log``
    takes the lines printed before the result."""
    cfg, trf = cell["config"], cell["traffic"]
    n, dim, metric = int(cfg["rows"]), int(cfg["dim"]), cfg["metric"]
    batch, clients, k = int(trf["batch"]), int(trf["clients"]), int(trf["k"])
    # fresh queries for a window at up to ``pool_qps``; past that the window ends early
    n_batches = max(clients, -(-int(float(trf["pool_qps"]) * seconds) // batch))
    keys = np.random.default_rng(data.sub_seed(seed, "sample")).random(n_batches)
    st = prepare(cell, seed, n_batches * batch, device)
    dev, cuda, qp, pool = st.dev, st.dev.type == "cuda", st.qp, st.pool
    if trace:
        capture_prime(dev)
    rows, columns, keep_rows, ids = st.rows, st.columns, st.keep_rows, st.ids
    setup_s = time.time() - t_start

    # ---- the window
    before = system.counters(qp)
    capture = Capture() if trace else None
    program_spans: Dict[tuple, None] = {}

    def during(t0: float) -> None:
        lead = min(float(trf["trace_lead_s"]), 0.3 * seconds)
        length = min(float(trf["trace_seconds"]), 0.5 * seconds)
        time.sleep(max(0.0, t0 + lead - time.perf_counter()))
        capture.start()
        end = time.perf_counter() + length
        while time.perf_counter() < end:
            time.sleep(min(0.25, max(0.0, end - time.perf_counter())))
            program_spans.update(dict.fromkeys(system.recent_spans()))
        capture.stop()
        program_spans.update(dict.fromkeys(system.recent_spans()))

    win = loop.closed_loop(st.call, pool, batch, clients, seconds, keys,
                           int(trf["check_calls"]), during if trace else None)
    if cuda:
        torch.cuda.synchronize(dev)
    after = system.counters(qp)
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    store = system.store_bytes(qp)
    reduced = capture.reduce(win.host_spans + list(program_spans)) if trace else None
    log(json.dumps({"counters": _delta(after, before)}))
    if reduced is not None:
        log(json.dumps({"trace": {"events": reduced["events"], "window_s": reduced["window_s"],
                                  "busy_s": reduced["busy_s"]}}))
    log(json.dumps({"window": {"seconds": win.seconds, "batches": len(win.calls),
                               "pool_out": win.pool_out, "gc": win.gc_summary()}}))
    for err in win.errors[:3]:
        log(err)

    # ---- free the program, then the reference on the kept answers
    del qp, st
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    kept = sorted(win.kept)
    qs = (np.concatenate([pool[j * batch:(j + 1) * batch] for j in kept])
          if kept else np.zeros((0, dim), np.float32))
    # a call's answers in query order; a query the call left without an answer is None
    answers = [a for j in kept for a in (list(win.kept[j]) + [None] * batch)[:batch]]
    t_ref = time.perf_counter()
    ref_rows, ref_dist = reference.exact_topk(_same_rows(seed, n, dim, dev, rows),
                                              torch.from_numpy(qs).to(dev), k, metric,
                                              keep_rows)
    id_to_row = {u: i for i, u in enumerate(ids)}
    checks = judge.judge(answers, qs, id_to_row, rows, columns, keep_rows, ref_rows, ref_dist,
                         k, metric, cfg["limits"])
    checks["missing"]["value"] += len(win.failed) * batch
    log(json.dumps({"reference": {"queries": int(qs.shape[0]), "calls": len(kept),
                                  "seconds": time.perf_counter() - t_ref}}))

    # ---- metrics
    ctx = SimpleNamespace(
        cell=cell, config=cfg, traffic=trf, window=win, setup_s=setup_s, store=store,
        delta=_delta(after, before), trace=reduced, rows_admitted=int(
            keep_rows.sum()) if keep_rows is not None else n)
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": int(cell["chips"]), "memory_peak_bytes": memory_peak}
    out = {"correct": judge.passed(checks), "attempted": len(win.calls) * batch,
           "failed": len(win.failed) * batch, "metrics": metrics, "device": device_info}
    if reduced is not None:
        device_info["busy_s"] = reduced["busy_s"]
        device_info["window_s"] = reduced["window_s"]
        out["breakdown"] = {"device_ops": reduced["device_ops"],
                            "idle_gaps": reduced["idle_gaps"]}
    out["checks"] = checks
    return out


def _same_rows(seed: int, n: int, dim: int, dev, rows: np.ndarray):
    """The rows drawn again on the device for the reference, each chunk's first row
    checked against the loaded copy (the generator must repeat itself)."""
    for lo, x in data.device_chunks(seed, "rows", n, dim, dev):
        if not np.array_equal(x[0].cpu().numpy(), rows[lo]):
            raise RuntimeError(f"rows drawn again differ from the loaded rows at row {lo}")
        yield lo, x
