"""The port's micro-batcher (mlvectordb_tpu_torch/engine/batcher.py) on the CPU: the cases of
tests/test_batcher.py against the port's QueryProcessor (device="cpu")."""

import asyncio
import threading

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.api.rest_api import RestAPI
from mlvectordb_tpu_torch.engine.batcher import MicroBatcher

SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128), use_pallas=False)


@pytest.fixture
def small_config():
    """The JAX tests' small config, as the port's EngineConfig."""
    return EngineConfig(**SMALL)


@pytest.fixture
def qp(small_config, rng):
    qp = QueryProcessor(small_config, device="cpu")
    qp.upsert_many(
        [VectorDTO(rng.standard_normal(16).astype(np.float32), {"i": i}) for i in range(100)],
        "ns",
    )
    return qp


def test_batched_results_match_direct(qp, rng):
    mb = MicroBatcher(qp, max_wait_us=2000)
    try:
        queries = [rng.standard_normal(16).astype(np.float32) for _ in range(24)]
        results = [None] * len(queries)

        def worker(i):
            results[i] = mb.find_similar(VectorDTO(queries[i]), top_k=5, namespace="ns", metric="l2")

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)

        for i, q in enumerate(queries):
            direct = qp.find_similar(VectorDTO(q), top_k=5, namespace="ns", metric="l2")
            assert [r["id"] for r in results[i]] == [r["id"] for r in direct]

        st = mb.stats()
        assert st["queries_executed"] == 24
        assert st["batches_executed"] < 24  # at least some coalescing happened
        assert st["avg_batch_size"] > 1.0
    finally:
        mb.close()


def test_mixed_topk_and_metric_grouping(qp, rng):
    mb = MicroBatcher(qp, max_wait_us=2000)
    try:
        out = {}

        def worker(name, k, metric):
            out[name] = mb.find_similar(
                VectorDTO(rng.standard_normal(16).astype(np.float32)),
                top_k=k, namespace="ns", metric=metric,
            )

        threads = [
            threading.Thread(target=worker, args=("a", 3, "l2")),
            threading.Thread(target=worker, args=("b", 7, "l2")),
            threading.Thread(target=worker, args=("c", 3, "cosine")),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)

        assert len(out["a"]) == 3 and len(out["b"]) == 7 and len(out["c"]) == 3
        # l2 ascending, cosine descending (reference score conventions)
        assert [r["score"] for r in out["b"]] == sorted(r["score"] for r in out["b"])
        assert [r["score"] for r in out["c"]] == sorted(
            (r["score"] for r in out["c"]), reverse=True
        )
    finally:
        mb.close()


def test_error_fans_out_not_hangs(qp):
    mb = MicroBatcher(qp, max_wait_us=1000)
    try:
        with pytest.raises(ValueError):
            mb.find_similar(VectorDTO(np.ones(3, np.float32)), top_k=2, namespace="ns")
    finally:
        mb.close()


def test_groups_execute_overlapped_not_head_of_line(rng):
    """Collection is decoupled from execution: four groups whose batches each
    take ~80 ms must run overlapped on the worker pool (wall << serial sum) and
    queue wait must stay near max_wait, not inherit prior batches' execution
    time (the round-4 load test's 29.5 ms head-of-line regression)."""
    import time as _time

    class SlowQP:
        class config:  # duck-typed: the batcher reads bucket_k + default_metric
            default_metric = "l2"

            @staticmethod
            def bucket_k(k):
                return k

        def find_similar_batch(self, queries, top_k, namespace, metric, filter):
            _time.sleep(0.08)
            return [[{"id": f"{namespace}-{j}", "score": 0.0}] * top_k
                    for j, _ in enumerate(queries)]

    mb = MicroBatcher(SlowQP(), max_wait_us=1000, exec_concurrency=4)
    try:
        results = {}

        def worker(ns):
            results[ns] = mb.find_similar(
                VectorDTO(rng.standard_normal(8).astype(np.float32)),
                top_k=2, namespace=ns, metric="l2",
            )

        t0 = _time.perf_counter()
        threads = [threading.Thread(target=worker, args=(f"ns{i}",)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        wall = _time.perf_counter() - t0

        assert len(results) == 4
        # serial head-of-line execution would take >= 4 * 80 ms = 320 ms
        assert wall < 0.25, f"groups did not overlap: wall={wall:.3f}s"
        st = mb.stats()
        assert st["batches_executed"] == 4
        # queue wait is enqueue->dispatch; it must not absorb execution time
        assert st["avg_queue_wait_ms"] < 60.0
    finally:
        mb.close()


def test_rest_auto_batch_mode(small_config, rng):
    async def runner():
        qp = QueryProcessor(small_config, device="cpu")
        qp.upsert_many(
            [VectorDTO(rng.standard_normal(8).astype(np.float32)) for _ in range(30)], "ns"
        )
        api = RestAPI(qp, enable_file_logging=False, log_level="WARNING",
                      batch_queries=True, batch_wait_us=2000)
        client = TestClient(TestServer(api.app))
        await client.start_server()
        try:
            q = rng.standard_normal(8).astype(float).tolist()
            resps = await asyncio.gather(
                *[
                    client.post("/search?namespace=ns", json={"query": q, "top_k": 3, "metric": "l2"})
                    for _ in range(8)
                ]
            )
            bodies = [await r.json() for r in resps]
            assert all(r.status == 200 for r in resps)
            assert all(b == bodies[0] for b in bodies)  # identical queries, identical results
            stats = await (await client.get("/statistics")).json()
            assert stats["micro_batcher"]["queries_executed"] == 8
        finally:
            await client.close()
            api.micro_batcher.close()

    asyncio.run(runner())
