"""Concurrency of the port: searches are lock-free snapshot reads, writes single-writer
(the cases of tests/test_concurrency.py, with filtered searches beside unfiltered ones).

Searches (filtered and unfiltered, find_similar_batch and range_search) race a writer
thread that inserts batches (``upsert_many``, growing the capacity), deletes and
compacts.  The writer compacts after every delete, so a freed slot is never reused while
an older snapshot may still be hydrated: each hit is then the row its snapshot ranked or
is dropped.  Every result must be one consistent snapshot's: each hit an id that was
inserted, carrying its own vector and metadata, its score the metric's distance between
the query and those values, best first; no hit outside its filter; no crash.
"""

import threading
import uuid

import numpy as np
import pytest

from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.filters import matches_filter

DIM = 16
SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128))
SPECS = (None, {"p": 0}, {"g": {"$lt": 3}}, {"$and": [{"p": 1}, {"g": {"$gte": 2}}]})


def _score(q, v, metric):
    q, v = q.astype(np.float64), v.astype(np.float64)
    if metric == "l2":
        return float(((q - v) ** 2).sum())
    return float(1.0 - q @ v) if metric == "ip" else float(
        q @ v / (np.linalg.norm(q) * np.linalg.norm(v)))


def _race(cfg, device, rounds=25, searchers=4, searches=30, n0=150):
    qp = QueryProcessor(EngineConfig(**cfg), device=device)
    rng = np.random.default_rng(0)
    known = {}                       # id -> (values, metadata), immutable per id
    known_lock = threading.Lock()

    def batch(local, gen, n):
        out = []
        for j in range(n):
            vid = uuid.uuid4()
            meta = {"p": j % 2, "g": gen % 5}
            vals = local.standard_normal(DIM).astype(np.float32)
            with known_lock:
                known[vid] = (vals, meta)
            out.append(VectorDTO(vals, meta, id=vid))
        return out

    base = qp.upsert_many(batch(rng, 0, n0), "ns")
    stop = threading.Event()
    errors, checked = [], []

    def writer():
        local = np.random.default_rng(1)
        live = [v.id for v in base]
        try:
            for gen in range(1, rounds + 1):
                live += [v.id for v in qp.upsert_many(batch(local, gen, 24), "ns")]
                victims = [live.pop(int(local.integers(len(live)))) for _ in range(12)]
                qp.delete(victims, "ns")
                with qp._write_lock:
                    qp.storage.namespace("ns").compact()
        except Exception as e:  # pragma: no cover
            errors.append(e)
        finally:
            stop.set()

    def check(q, res, metric, spec, k):
        assert len(res) <= k
        scores = [r["score"] for r in res]
        assert scores == sorted(scores, reverse=metric == "cosine")
        for r in res:
            vals, meta = known[r["id"]]
            np.testing.assert_array_equal(r["values"], vals)
            assert r["metadata"] == meta and matches_filter(meta, spec)
            assert np.isfinite(r["score"])
            assert abs(r["score"] - _score(q, vals, metric)) <= 1e-4 * (1 + abs(r["score"]))

    def searcher(seed):
        local = np.random.default_rng(seed)
        try:
            i = 0
            while i < searches or not stop.is_set():
                q = local.standard_normal(DIM).astype(np.float32)
                spec = SPECS[i % len(SPECS)]
                metric = ("l2", "cosine", "ip")[i % 3]
                if i % 5 == 4:
                    res = qp.range_search(VectorDTO(q), 40.0 if metric != "cosine" else 0.0,
                                          "ns", metric, filter=spec, limit=20)
                    check(q, res, metric, spec, 20)
                else:
                    (res,) = qp.find_similar_batch([VectorDTO(q)], 10, "ns", metric,
                                                   filter=spec)
                    check(q, res, metric, spec, 10)
                checked.append(len(res))
                i += 1
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer)] + [
        threading.Thread(target=searcher, args=(100 + i,)) for i in range(searchers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert len(checked) >= searchers * searches and sum(checked) > 0
    ns = qp.storage.namespace("ns")
    assert ns.live_count == n0 + rounds * 12
    # afterwards: one consistent store, its native columns in step with its metadata
    mask = ns.meta_columns.eval({"p": 0}, ns.capacity)
    assert {s for s, _, m in ns.iter_slots() if m["p"] == 0} == set(np.flatnonzero(mask))
    res = qp.find_similar_batch([VectorDTO(np.zeros(DIM, np.float32))], ns.live_count, "ns",
                                filter={"p": 1})
    assert len(res[0]) == sum(1 for _, _, m in ns.iter_slots() if m["p"] == 1)
    return qp


@pytest.mark.parametrize("sweep", [False, True])
def test_filtered_and_unfiltered_searches_race_writes_and_compactions(sweep):
    # the sweep variant holds 4096+ rows: the certified sweep serves it (two tiles)
    cfg = dict(sweep_dtype="bfloat16") if sweep else dict(SMALL)
    _race(cfg, "cpu", n0=8200 if sweep else 150)


def test_concurrent_writers_serialize():
    """Two writer threads on one namespace; the final state is consistent and every live
    id is searchable, with and without a filter."""
    qp = QueryProcessor(EngineConfig(**SMALL), device="cpu")
    errors = []

    def writer(seed):
        local = np.random.default_rng(seed)
        try:
            for i in range(20):
                vs = qp.upsert_many(
                    [VectorDTO(local.standard_normal(8).astype(np.float32), {"w": seed})
                     for _ in range(5)], "ns")
                if i % 3 == 0:
                    qp.delete([vs[0].id], "ns")
        except Exception as e:  # pragma: no cover
            errors.append(e)

    ts = [threading.Thread(target=writer, args=(s,)) for s in (1, 2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errors, errors
    ns = qp.storage.namespace("ns")
    expected = 2 * (20 * 5 - 7)
    assert ns.live_count == expected
    q = VectorDTO(np.zeros(8, np.float32))
    assert len(qp.find_similar(q, top_k=expected, namespace="ns")) == expected
    assert len(qp.find_similar(q, top_k=expected, namespace="ns", filter={"w": 2})) == (
        expected // 2)



@pytest.mark.parametrize("engine", ["port", "jax"])
def test_filtered_search_during_a_compaction_sees_one_layout(engine):
    """A filtered search that starts while a compaction sits between its version bump and
    its publish (tables and metadata columns already in the new layout, the old snapshot
    still published).  One tombstone at slot 0 shifts every row by one slot, so a mask of
    the new layout over the old snapshot's rows selects the other parity.  The port builds
    the mask under the namespace lock against the published snapshot, so the search waits
    for the publish, re-snapshots and answers from one layout.  The JAX package builds it
    without the lock and its version check passes (the version moved before the search
    read it): it returns 50 rows of the other parity (ROADMAP §C, C5)."""
    if engine == "jax":
        from mlvectordb_tpu.config import EngineConfig as Config
        from mlvectordb_tpu.engine.query_processor import QueryProcessor as Processor
        from mlvectordb_tpu.interfaces.vector import VectorDTO as DTO

        qp = Processor(config=Config(**SMALL, use_pallas=False))
    else:
        qp, DTO = QueryProcessor(EngineConfig(**SMALL), device="cpu"), VectorDTO
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((200, DIM)).astype(np.float32)
    ids = qp.bulk_load(vals, "ns", metadatas=[{"p": i % 2} for i in range(200)])
    qp.delete([ids[0]], "ns")
    ns = qp.storage.namespace("ns")
    q = rng.standard_normal(DIM).astype(np.float32)
    qp.find_similar_batch([DTO(q + 1)], 50, "ns", "l2", filter={"p": 1})   # warm
    real, box = ns._rebuild_meta_columns, {}

    def mid_compaction():
        real()
        t = threading.Thread(target=lambda: box.setdefault("res", qp.find_similar_batch(
            [DTO(q)], 50, "ns", "l2", filter={"p": 0})))
        t.start()
        # the search runs now (JAX), or waits for the namespace lock (the port)
        t.join(timeout=5.0 if engine == "jax" else 1.0)
        box["thread"] = t

    ns._rebuild_meta_columns = mid_compaction
    with qp._write_lock:
        ns.compact()
    box["thread"].join(timeout=60)
    (res,) = box["res"]
    assert ns.capacity == 256 and ns._tombstones == 0 and len(res) == 50
    parity = {r["metadata"]["p"] for r in res}
    if engine == "jax":
        assert parity == {1}
        return
    assert parity == {0}
    d = ((vals[2::2].astype(np.float64) - q) ** 2).sum(-1)
    assert {r["id"] for r in res} == {ids[2 + 2 * i] for i in np.argsort(d)[:50]}
