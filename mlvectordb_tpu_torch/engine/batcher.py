"""Micro-batching query executor: a copy of ``mlvectordb_tpu/engine/batcher.py`` (which
the port cannot import: importing the JAX package pulls in JAX).

A single query keeps a search kernel's query columns nearly empty while the kernel still
sweeps the whole namespace, so under concurrent load it is cheaper to hold a query for a
few hundred microseconds and ride a shared launch than to launch alone.

Mechanics: callers enqueue (query, k, namespace, metric, filter) and block on a per-item
event.  A collector thread drains the queue, groups by (namespace, metric, k-bucket,
filter-key) — queries in one group share a single find_similar_batch call — and fans
results back out.  max_wait_us bounds added latency; max_batch bounds kernel batch width.

Execution is decoupled from collection: groups run on a small worker pool
(exec_concurrency in flight), so the collector goes straight back to draining the queue
while a batch executes instead of holding new arrivals behind it.  When all workers are
busy the collector blocks before forming the next batch, so arrivals coalesce into larger
batches instead of growing an unbounded execution backlog.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

from ..config import canonical_metric
from ..filters import filter_cache_key
from ..interfaces.vector import VectorDTO


class _Pending:
    __slots__ = ("query", "top_k", "namespace", "metric", "filter", "event", "result",
                 "error", "enqueued")

    def __init__(self, query, top_k, namespace, metric, filter):
        self.query = query
        self.top_k = top_k
        self.namespace = namespace
        self.metric = metric
        self.filter = filter
        self.event = threading.Event()
        self.result: Optional[List[Dict[str, Any]]] = None
        self.error: Optional[BaseException] = None
        self.enqueued = time.perf_counter()


class MicroBatcher:
    """Wraps a QueryProcessor with a coalescing search path."""

    def __init__(
        self,
        query_processor,
        max_wait_us: int = 500,
        max_batch: int = 512,
        exec_concurrency: int = 4,
    ):
        self.qp = query_processor
        self.max_wait_s = max_wait_us / 1e6
        self.max_batch = max_batch
        self._queue: "queue.SimpleQueue[_Pending]" = queue.SimpleQueue()
        self._shutdown = False
        self.batches_executed = 0
        self.queries_executed = 0
        self.total_wait_ms = 0.0   # enqueue -> group dispatch, summed over queries
        self.total_exec_ms = 0.0   # find_similar_batch wall, summed over batches
        self._stats_lock = threading.Lock()
        # bounded execution overlap: snapshot reads are RCU-safe concurrently, and
        # overlapping dispatches pipelines the host<->device copies of the batches
        self._inflight = threading.Semaphore(max(1, exec_concurrency))
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, exec_concurrency), thread_name_prefix="microbatch-exec"
        )
        self._thread = threading.Thread(target=self._collector, daemon=True, name="microbatcher")
        self._thread.start()

    # ------------------------------------------------------------------ public API

    def find_similar(
        self,
        query: VectorDTO,
        top_k: int = 10,
        namespace: str = "default",
        metric: Optional[str] = None,
        filter: Optional[Dict[str, Any]] = None,
        timeout: float = 180.0,  # must cover a first call's kernel build
    ) -> List[Dict[str, Any]]:
        """Same contract as QueryProcessor.find_similar, but batched across callers."""
        m = canonical_metric(metric or self.qp.config.default_metric)
        item = _Pending(query, top_k, namespace, m, filter)
        self._queue.put(item)
        if not item.event.wait(timeout):
            raise TimeoutError("micro-batched search timed out")
        if item.error is not None:
            raise item.error
        return item.result

    def close(self) -> None:
        self._shutdown = True
        self._thread.join(timeout=5)
        self._pool.shutdown(wait=True, cancel_futures=False)

    # ------------------------------------------------------------------ collector

    def _group_key(self, it: _Pending):
        kb = self.qp.config.bucket_k(max(it.top_k, 1))
        fk = filter_cache_key(it.filter) if it.filter else ""
        return (it.namespace, it.metric, kb, fk)

    def _collector(self) -> None:
        while not self._shutdown:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break

            groups: Dict[Any, List[_Pending]] = {}
            for it in batch:
                groups.setdefault(self._group_key(it), []).append(it)
            for items in groups.values():
                # blocks only when every worker is busy — arrivals then pile up
                # in the queue and form LARGER batches, instead of the collector
                # itself becoming the head-of-line bottleneck
                self._inflight.acquire()
                self._pool.submit(self._exec_group, items)

    def _exec_group(self, items: Sequence[_Pending]) -> None:
        try:
            self._run_group(items)
        finally:
            self._inflight.release()

    def _run_group(self, items: Sequence[_Pending]) -> None:
        try:
            t0 = time.perf_counter()
            wait_ms = sum((t0 - it.enqueued) * 1e3 for it in items)
            k = max(it.top_k for it in items)
            results = self.qp.find_similar_batch(
                [it.query for it in items],
                top_k=k,
                namespace=items[0].namespace,
                metric=items[0].metric,
                filter=items[0].filter,
            )
            exec_ms = (time.perf_counter() - t0) * 1e3
            with self._stats_lock:
                self.total_wait_ms += wait_ms
                self.total_exec_ms += exec_ms
                self.batches_executed += 1
                self.queries_executed += len(items)
            for it, res in zip(items, results):
                it.result = res[: it.top_k]
                it.event.set()
        except BaseException as e:  # noqa: BLE001 - fan the error out to every caller
            for it in items:
                it.error = e
                it.event.set()

    def stats(self) -> Dict[str, Any]:
        """Counters + the per-stage latency budget: avg queue wait (enqueue ->
        dispatch) per query and avg kernel+hydrate execution per batch, so a load
        test can itemize where serving latency goes."""
        return {
            "batches_executed": self.batches_executed,
            "queries_executed": self.queries_executed,
            "avg_batch_size": (
                self.queries_executed / self.batches_executed if self.batches_executed else 0.0
            ),
            "avg_queue_wait_ms": (
                self.total_wait_ms / self.queries_executed if self.queries_executed else 0.0
            ),
            "avg_exec_ms_per_batch": (
                self.total_exec_ms / self.batches_executed if self.batches_executed else 0.0
            ),
        }
