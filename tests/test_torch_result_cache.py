"""The port's result cache (engine/query_processor.py) on the CPU.

An entry is a handful of flat arrays (``_pack_results``): each query's row count, the
rows' ids, values and metadata by reference, and their scores as float64.  A hit
rebuilds new lists of new row dicts from them, equal to the miss's results, on every
search path (plain, filtered, IVF, sharded); the key, the LRU, ``result_cache_size`` and
``get_statistics()["result_cache"]`` are checked here, and that an entry leaves no
per-row container for the garbage collector to walk.
"""

import gc
import uuid

import numpy as np
import pytest
import torch

from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.parallel import make_distributed_processor

SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64, 512), k_buckets=(8, 32, 128), use_pallas=False)
DIM = 16


def _qp(n=320, sharded=False, **kw):
    cfg = EngineConfig(**dict(SMALL, **kw))
    if sharded:
        qp = make_distributed_processor(1, 2, cfg, devices=[torch.device("cpu")] * 2)
    else:
        qp = QueryProcessor(cfg, device="cpu")
    rng = np.random.default_rng(7)
    rows = rng.standard_normal((n, DIM)).astype(np.float32)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, n)]
    qp.bulk_load(rows, "ns", ids=ids,
                 metadatas=[{"i": i, "g": "ab"[i % 2]} for i in range(n)])
    return qp, rows


def _queries(rows, b=4):
    return [VectorDTO(r + 0.01) for r in rows[:b]]


def _search(qp, queries, path, k=5):
    kw = {"filter": {"g": "a"}} if path == "filtered" else {}
    if path == "ivf":
        kw["nprobe"] = 2
    return qp.find_similar_batch(queries, k, "ns", "l2", **kw)


def _stats(qp):
    return qp.get_statistics()["result_cache"]


@pytest.mark.parametrize("path", ["plain", "filtered", "ivf", "sharded"])
def test_hit_equals_the_miss(path):
    qp, rows = _qp(sharded=path == "sharded")
    if path == "ivf":
        qp.build_ivf("ns", n_clusters=4, n_iters=5, seed=0)
    queries = _queries(rows)
    miss = _search(qp, queries, path)
    hit = _search(qp, queries, path)
    assert qp._result_cache_hits == 1 and _stats(qp) == {"entries": 1, "stores": 1,
                                                        "hits": 1}
    assert hit == miss and all(len(rs) == 5 for rs in hit)
    if path == "filtered":
        assert all(r["metadata"]["g"] == "a" for rs in hit for r in rs)
    for a, b in zip(miss, hit):
        assert a is not b
        for ra, rb in zip(a, b):
            assert ra is not rb and list(rb) == ["id", "values", "metadata", "score"]
            # the same objects: ids, values and metadata by reference, the score exact
            assert all(rb[key] is ra[key] for key in ("id", "values", "metadata"))
            assert type(rb["score"]) is float and rb["score"] == ra["score"]


@pytest.mark.parametrize("mutated", ["miss", "hit"])
def test_mutating_returned_rows_and_lists_changes_no_later_hit(mutated):
    qp, rows = _qp()
    queries = _queries(rows)
    first = _search(qp, queries, "plain")
    want = [[dict(r) for r in rs] for rs in first]
    target = first if mutated == "miss" else _search(qp, queries, "plain")
    target[0][0]["score"] = -1.0
    target[0][1]["id"] = None
    target[1].clear()
    target.append([])
    hit = _search(qp, queries, "plain")
    assert hit == want and hit is not target and hit[0] is not target[0]
    again = _search(qp, queries, "plain")
    assert again == want and again[0][0] is not hit[0][0]


@pytest.mark.parametrize("change", ["write", "build_ivf", "incarnation"])
def test_a_change_makes_the_next_search_a_miss(change):
    qp, rows = _qp()
    queries = _queries(rows)
    first = _search(qp, queries, "plain")
    if change == "write":
        qp.upsert_many([VectorDTO(rows[0] + 0.01, {"i": -1})], "ns")
    elif change == "build_ivf":
        qp.build_ivf("ns", n_clusters=4, n_iters=5, seed=0)
    else:
        # the same load under new ids: the namespace's version restarts where it was,
        # so only its incarnation tells the two apart
        version = qp.storage.namespace("ns").version
        qp.delete_namespace("ns")
        qp.bulk_load(rows, "ns", ids=[uuid.UUID(int=i + 1) for i in range(len(rows))],
                     metadatas=[{"i": i} for i in range(len(rows))])
        assert qp.storage.namespace("ns").version == version
    second = _search(qp, queries, "plain")
    assert qp._result_cache_hits == 0 and _stats(qp)["stores"] == 2
    if change == "write":
        assert second[0][0]["metadata"] == {"i": -1}
    elif change == "incarnation":
        assert second != first
        assert second[0][0]["id"] == uuid.UUID(int=1)
    else:
        assert second == first


def test_lru_evicts_the_least_recently_used():
    qp, rows = _qp(result_cache_size=3)
    qs = [[VectorDTO(r + 0.01)] for r in rows[:4]]
    for q in qs[:3]:
        _search(qp, q, "plain")
    _search(qp, qs[0], "plain")   # touch: qs[1] is now the least recently used
    _search(qp, qs[3], "plain")   # evicts qs[1]
    assert len(qp._result_cache) == 3 and _stats(qp) == {"entries": 3, "stores": 4,
                                                        "hits": 1}
    _search(qp, qs[0], "plain")
    _search(qp, qs[2], "plain")
    _search(qp, qs[3], "plain")
    assert qp._result_cache_hits == 4
    _search(qp, qs[1], "plain")   # a miss that evicts qs[0]
    assert qp._result_cache_hits == 4 and _stats(qp)["stores"] == 5
    _search(qp, qs[0], "plain")
    assert qp._result_cache_hits == 4 and len(qp._result_cache) == 3


def test_a_zero_size_cache_stores_nothing():
    qp, rows = _qp(result_cache_size=0)
    queries = _queries(rows)
    assert _search(qp, queries, "plain") == _search(qp, queries, "plain")
    assert not qp._result_cache and _stats(qp) == {"entries": 0, "stores": 0, "hits": 0}
    assert qp.get_statistics()["queries_by_type"] == {"knn": 2}


def test_statistics_count_entries_stores_and_hits():
    qp, rows = _qp()
    assert _stats(qp) == {"entries": 0, "stores": 0, "hits": 0}
    a, b = _queries(rows[:2], 1), _queries(rows[2:4], 1)
    _search(qp, a, "plain")
    _search(qp, b, "plain")
    _search(qp, a, "plain")
    _search(qp, a, "filtered")
    assert _stats(qp) == {"entries": 3, "stores": 3, "hits": 1}
    qp._result_cache.clear()
    _search(qp, a, "plain")
    assert _stats(qp) == {"entries": 1, "stores": 4, "hits": 1}


def test_a_stored_call_leaves_few_tracked_objects():
    """A 512-query, k = 10 call whose results are dropped grows the collector's tracked
    objects by a few, not by one container per returned row (5,120 row dicts and 512
    lists in nested form).  Measured between the second and third calls, after a
    collection, so that first-call warm-up does not count."""
    qp, rows = _qp(n=2048)
    rng = np.random.default_rng(11)
    batches = [[VectorDTO(q) for q in rng.standard_normal((512, DIM)).astype(np.float32)]
               for _ in range(3)]
    for queries in batches[:2]:
        assert sum(map(len, qp.find_similar_batch(queries, 10, "ns", "l2"))) == 5120
    gc.collect()
    before = len(gc.get_objects())
    assert sum(map(len, qp.find_similar_batch(batches[2], 10, "ns", "l2"))) == 5120
    gc.collect()
    grown = len(gc.get_objects()) - before
    assert _stats(qp) == {"entries": 3, "stores": 3, "hits": 0}
    assert grown < 500, grown
