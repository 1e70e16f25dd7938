"""The system under test: ``mlvectordb_tpu_torch``'s ``QueryProcessor`` over one
namespace, loaded through ``bulk_load``, and the program's own counters that the
per-layer metrics read.  The only module of the benchmark that imports the port."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

NAMESPACE = "bench"


def build(config: dict, rows: np.ndarray, metas: Optional[List[dict]], device):
    """(processor, the uuids ``bulk_load`` returned, in row order)."""
    from mlvectordb_tpu_torch import EngineConfig, QueryProcessor

    qp = QueryProcessor(EngineConfig(**config.get("engine", {})), device=device)
    ids = qp.bulk_load(rows, namespace=NAMESPACE, metadatas=metas)
    return qp, ids


def dtos(queries: np.ndarray) -> list:
    """One request's query objects, as a client builds them."""
    from mlvectordb_tpu_torch import VectorDTO

    return [VectorDTO(q) for q in queries]


def counters(qp) -> Dict:
    """The program's counters: stage walls of ``QueryStats``, ``RECORDER``'s spans,
    certificate tiers, copies."""
    from mlvectordb_tpu_torch.utils.tracing import RECORDER

    stats = qp.stats
    with stats._lock:
        stage_ms, stage_n = dict(stats._stage_ms), dict(stats._stage_counts)
    return {
        "stage_ms": stage_ms,
        "stage_n": stage_n,
        "spans": {n: (a["total_ms"], a["count"]) for n, a in RECORDER.summary().items()},
        "tiers": qp.cert_tier_counts(NAMESPACE),
        "h2d": qp.transfer_counts["h2d"],
        "d2h": qp.transfer_counts["d2h"],
        "settle_copies": qp.settle_copies,
    }


def recent_spans(limit: int = 2048) -> list:
    """(name, wall start ns, wall end ns) of the program's most recent spans."""
    from mlvectordb_tpu_torch.utils.tracing import RECORDER

    return [(s["name"], int(s["start"] * 1e9), int((s["start"] + s["elapsed_ms"] * 1e-3) * 1e9))
            for s in RECORDER.recent(limit)]


def store_bytes(qp) -> Dict[str, int]:
    """Device bytes of the namespace's store and its live rows."""
    ns = qp.storage.namespace(NAMESPACE)
    return {"nbytes": int(ns.nbytes), "live": int(ns.live_count), "dim": int(ns.dim)}
