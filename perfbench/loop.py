"""The traffic: a fixed number of closed-loop clients, each sending a batch of fresh
queries and the next as soon as the last returns, as the port's micro-batcher's executor
does under load (``max_batch=512``, ``exec_concurrency=4``).

Clients take batch indices from one shared counter until the deadline: batch j is rows
[j * batch, (j + 1) * batch) of the query pool, so no query repeats.  No batch is
handed out after ``seconds``; the window runs from the first start to the last return,
and a call's latency from its start to its return.  The answers of the ``keep`` batches
with the smallest keys drawn from the seed are kept for the comparison; the rest are
dropped as they return.  The interpreter's garbage collections in the window are timed
through ``gc.callbacks``: each holds every client.
"""

from __future__ import annotations

import gc
import heapq
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclass
class Window:
    t0: float = 0.0
    t1: float = 0.0
    calls: List[tuple] = field(default_factory=list)     # (batch j, start, end) perf_counter
    failed: List[int] = field(default_factory=list)      # batches whose call raised
    errors: List[str] = field(default_factory=list)
    kept: Dict[int, list] = field(default_factory=dict)  # batch j -> its answers
    host_spans: List[tuple] = field(default_factory=list)  # (name, wall ns, wall ns)
    gc_pauses: List[tuple] = field(default_factory=list)   # (generation, seconds)
    pool_out: bool = False                               # the pool ran out before the deadline

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def latencies_ms(self) -> np.ndarray:
        """Each call's latency from its start to its return, in milliseconds."""
        return np.array([(e - s) * 1e3 for _, s, e in self.calls], np.float64)

    def latency_ms(self, q: float) -> Optional[float]:
        lat = self.latencies_ms()
        return float(np.percentile(lat, q)) if lat.size else None

    def gc_summary(self) -> Dict:
        by_gen: Dict[int, List[float]] = {}
        for g, s in self.gc_pauses:
            by_gen.setdefault(g, []).append(s)
        return {f"gen{g}": {"n": len(v), "s": sum(v), "max_s": max(v)}
                for g, v in sorted(by_gen.items())}


def closed_loop(call: Callable[[np.ndarray], list], pool: np.ndarray, batch: int,
                clients: int, seconds: float, keys: np.ndarray, keep: int,
                during: Optional[Callable[[float], None]] = None) -> Window:
    """``clients`` threads call ``call`` on batch after batch of ``pool`` until
    ``seconds`` have passed.  ``keys[j]``: batch j's sampling key.  ``during(t0)`` runs on
    this thread meanwhile (the trace)."""
    win = Window()
    lock = threading.Lock()
    heap: List[tuple] = []  # (-key, j): the kept batches, largest key on top
    n_batches = min(len(keys), pool.shape[0] // batch)
    next_j = [0]
    gc_start = [0.0, 0]

    def on_gc(phase: str, info: dict) -> None:
        if phase == "start":
            gc_start[0], gc_start[1] = time.perf_counter(), time.time_ns()
        else:
            win.gc_pauses.append((info["generation"], time.perf_counter() - gc_start[0]))
            win.host_spans.append((f"gc.gen{info['generation']}", gc_start[1], time.time_ns()))

    def client():
        while True:
            with lock:
                j = next_j[0]
                if time.perf_counter() >= deadline:
                    return
                if j >= n_batches:
                    win.pool_out = True
                    return
                next_j[0] = j + 1
            qs = pool[j * batch:(j + 1) * batch]
            ws, ts = time.time_ns(), time.perf_counter()
            try:
                res = call(qs)
            except Exception:  # a call that raises leaves its batch unanswered
                res = None
                err = traceback.format_exc(limit=4)
            te, we = time.perf_counter(), time.time_ns()
            with lock:
                win.calls.append((j, ts, te))
                win.host_spans.append(("client.call", ws, we))
                if res is None:
                    win.failed.append(j)
                    win.errors.append(err)
                elif len(heap) < keep:
                    heapq.heappush(heap, (-keys[j], j))
                    win.kept[j] = res
                elif keep and keys[j] < -heap[0][0]:
                    _, out = heapq.heapreplace(heap, (-keys[j], j))
                    del win.kept[out]
                    win.kept[j] = res

    threads = [threading.Thread(target=client, name=f"client{i}") for i in range(clients)]
    gc.callbacks.append(on_gc)
    try:
        win.t0 = time.perf_counter()
        deadline = win.t0 + seconds
        for t in threads:
            t.start()
        if during is not None:
            during(win.t0)
        for t in threads:
            t.join()
    finally:
        gc.callbacks.remove(on_gc)
    win.t1 = max((e for *_, e in win.calls), default=win.t0)
    return win
