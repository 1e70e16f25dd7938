"""The ported serving slice as a whole, against the JAX package's QueryProcessor.

A JAX QueryProcessor (CPU) and a torch QueryProcessor(device="cpu") load the same
20,000 x 128 corpus under the same uuids; the namespace capacity (32768) puts both on
the fused row-major path: the torch side's plain window-min versions, and the JAX side's
Pallas kernels in interpret mode (its backend is told it runs on a TPU, as
tests/test_torch_int8.py does).  Both rescan with the same formulas, the l2 expansion
qn + ||row||^2 - 2 q.row included.  Results must name the same ids in the same order with
scores within 1e-4.
"""

import subprocess
import sys
import types
import uuid

import numpy as np
import pytest
import torch

from mlvectordb_tpu.config import EngineConfig as JaxConfig
from mlvectordb_tpu.engine.query_processor import QueryProcessor as JaxQueryProcessor
from mlvectordb_tpu.interfaces.vector import VectorDTO as JaxDTO
from mlvectordb_tpu.ops import backend as jax_backend
from mlvectordb_tpu.store.storage import StorageEngine as JaxStorage
from mlvectordb_tpu.store.vector import Vector as JaxVector
from mlvectordb_tpu_torch import (
    EngineConfig, QueryProcessor, StorageEngine, Vector, VectorDTO, convert,
)
from mlvectordb_tpu_torch.ops.backend import knn_backend

N, D = 20_000, 128
METRICS = ["l2", "ip", "cosine"]


@pytest.fixture
def corpus():
    rng = np.random.default_rng(2024)
    x = rng.standard_normal((N, D), dtype=np.float32)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, N)]
    meta = [{"i": i} for i in range(N)]
    queries = rng.standard_normal((16, D), dtype=np.float32)
    return rng, x, ids, meta, queries


@pytest.fixture
def pair(corpus):
    _, x, ids, meta, _ = corpus
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backend, "jax", types.SimpleNamespace(default_backend=lambda: "tpu"))
        jqp = JaxQueryProcessor(config=JaxConfig())
        tqp = QueryProcessor(EngineConfig(), device="cpu")
        jqp.bulk_load(x, "ns", ids=ids, metadatas=meta)
        tqp.bulk_load(x, "ns", ids=ids, metadatas=meta)
        assert tqp.storage.namespace("ns").capacity == 32768
        yield jqp, tqp


def _search_both(jqp, tqp, queries, k, metric, namespace="ns"):
    jr = jqp.find_similar_batch([JaxDTO(q) for q in queries], k, namespace, metric)
    tr = tqp.find_similar_batch([VectorDTO(q) for q in queries], k, namespace, metric)
    return jr, tr


def _assert_same_results(jr, tr):
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        assert [r["id"] for r in a] == [r["id"] for r in b]
        np.testing.assert_allclose([r["score"] for r in b], [r["score"] for r in a],
                                   rtol=1e-4, atol=1e-4)
        for ra, rb in zip(a, b):
            assert ra["metadata"] == rb["metadata"]
            np.testing.assert_array_equal(ra["values"], rb["values"])


@pytest.mark.parametrize("metric", METRICS)
def test_search_matches_jax(pair, corpus, metric):
    jqp, tqp = pair
    queries = corpus[4]
    jr, tr = _search_both(jqp, tqp, queries, 10, metric)
    _assert_same_results(jr, tr)
    assert all(len(r) == 10 for r in tr)


@pytest.mark.parametrize("metric", METRICS)
def test_search_after_upsert_and_delete_matches_jax(pair, corpus, metric):
    rng, x, ids, _, queries = corpus
    jqp, tqp = pair
    # overwrite 500 ids in place with new values (the queries' near neighbours among them)
    over = rng.choice(N, 500, replace=False)
    newv = rng.standard_normal((500, D), dtype=np.float32)
    newv[:16] = queries + np.float32(1e-2)
    jqp.upsert_many([JaxDTO(v, {"new": 1}, id=ids[i]) for i, v in zip(over, newv)], "ns")
    tqp.upsert_many([VectorDTO(v, {"new": 1}, id=ids[i]) for i, v in zip(over, newv)], "ns")
    assert tqp.get_namespace_count("ns") == N
    _assert_same_results(*_search_both(jqp, tqp, queries, 10, metric))

    # tombstones (below the compaction threshold): the torch side takes the masked kernel
    gone = [ids[i] for i in over[:8]] + [ids[i] for i in rng.choice(N, 300, replace=False)]
    assert sorted(map(str, jqp.delete(gone, "ns"))) == sorted(map(str, tqp.delete(gone, "ns")))
    state = tqp.storage.namespace("ns").device_state()
    assert state.live_count < state.high_water
    jr, tr = _search_both(jqp, tqp, queries, 10, metric)
    _assert_same_results(jr, tr)
    dead = set(gone)
    assert not any(r["id"] in dead for rs in tr for r in rs)


def test_compaction_matches_jax(pair, corpus):
    _, _, ids, _, queries = corpus
    jqp, tqp = pair
    gone = ids[: N // 4]  # above the 0.2 tombstone ratio: both sides compact
    jqp.delete(gone, "ns")
    tqp.delete(gone, "ns")
    ns = tqp.storage.namespace("ns")
    assert ns._tombstones == 0 and ns.capacity == 16384
    assert ns.device_state().high_water == ns.live_count == N - N // 4
    for metric in METRICS:
        _assert_same_results(*_search_both(jqp, tqp, queries, 10, metric))


def test_k_clamped_missing_namespace_and_transfers(corpus):
    _, x, _, _, queries = corpus
    tqp = QueryProcessor(EngineConfig(), device="cpu")
    assert tqp.find_similar_batch([VectorDTO(queries[0])], 10, "nope") == [[]]
    vs = tqp.upsert_many([VectorDTO(v) for v in x[:5]], "small")
    before = dict(tqp.transfer_counts)
    res = tqp.find_similar(VectorDTO(x[3]), top_k=10, namespace="small", metric="euclidean")
    assert (tqp.transfer_counts["h2d"] - before["h2d"],
            tqp.transfer_counts["d2h"] - before["d2h"]) == (1, 1)
    # (capacity 4096 takes the scan: its norm-expansion form leaves a few ulps of |x|^2)
    assert len(res) == 5 and res[0]["id"] == vs[3].id and 0.0 <= res[0]["score"] < 1e-3
    # a second identical search is served from the result cache: no transfers
    assert tqp.find_similar(VectorDTO(x[3]), 10, "small", "l2") == res
    assert tqp._result_cache_hits == 1 and tqp.transfer_counts["h2d"] == before["h2d"] + 1
    # deleting the last vector garbage-collects the namespace
    tqp.delete([v.id for v in vs], "small")
    assert tqp.list_namespaces() == [] and tqp.find_similar(VectorDTO(x[0]), 3, "small") == []


def test_cosine_scores_and_insert(corpus):
    _, x, _, _, _ = corpus
    jqp = JaxQueryProcessor(config=JaxConfig())
    tqp = QueryProcessor(EngineConfig(), device="cpu")
    for i in range(40):
        vid = uuid.UUID(int=i + 1)
        jqp.insert(JaxDTO(x[i], {"i": i}, id=vid), "c")
        tqp.insert(VectorDTO(x[i], {"i": i}, id=vid), "c")
    _assert_same_results(*_search_both(jqp, tqp, x[:3], 7, "cosine", "c"))


def test_carry_over_from_jax_snapshot(pair, corpus):
    jqp, _ = pair
    queries = corpus[4]
    jqp.delete(corpus[2][:100], "ns")
    snap = jqp.storage.namespace("ns").snapshot_arrays()
    ns = convert.store_from_jax_snapshot(snap, EngineConfig(), "cpu")
    assert ns.live_count == N - 100 and ns.dim == D
    fresh = QueryProcessor(EngineConfig(), device="cpu")
    fresh.storage.attach(ns)
    with pytest.raises(ValueError):
        fresh.storage.attach(ns)  # the name is taken
    assert ns.snapshot_arrays()["ids"] == snap["ids"]
    for metric in METRICS:
        _assert_same_results(*_search_both(jqp, fresh, queries, 10, metric))


def test_every_option_is_served():
    # a bf16 store serves row-major and under every sweep mirror: the same-dtype bf16
    # one, int8 codes with one or two streams and an f32 mirror, each answering a
    # certified search at tier 0 over two sweep tiles
    rows = np.random.default_rng(2).standard_normal((8192, 16)).astype(np.float32)
    for sweep, resid in ((None, True), ("bfloat16", True), ("int8", True), ("int8", False),
                         ("float32", True)):
        cfg = EngineConfig(dtype="bfloat16", sweep_dtype=sweep, sweep_resid=resid)
        bq = QueryProcessor(cfg, device="cpu")
        bq.bulk_load(rows, "ns", ids=[uuid.UUID(int=i + 1) for i in range(len(rows))])
        hit = bq.find_similar(VectorDTO(rows[7]), top_k=3, namespace="ns", metric="l2")
        assert hit[0]["id"] == uuid.UUID(int=8)
        # (the row-major path proves its batch too since ROADMAP C20)
        assert bq.cert_tier_counts("ns") == {"fast": 1}
    tqp = QueryProcessor(EngineConfig(), device="cpu")
    q = [VectorDTO(np.ones(4, np.float32))]
    # filter= is served (tests/test_torch_filters.py): a missing namespace answers []
    assert tqp.find_similar_batch(q, 3, "ns", filter={"a": 1}) == [[]]
    # nprobe= with no IVF index built serves the exact path, as in the JAX package
    x = np.random.default_rng(3).standard_normal((50, 4)).astype(np.float32)
    jqp = JaxQueryProcessor(config=JaxConfig())
    for qp in (jqp, tqp):
        qp.bulk_load(x, "ns", ids=[uuid.UUID(int=i + 1) for i in range(50)])
    want = jqp.find_similar_batch([JaxDTO(v) for v in x[:3]], 3, "ns", "l2", nprobe=4)
    got = tqp.find_similar_batch([VectorDTO(v) for v in x[:3]], 3, "ns", "l2", nprobe=4)
    assert [[r["id"] for r in a] for a in got] == [[r["id"] for r in a] for a in want]
    assert got == tqp.find_similar_batch([VectorDTO(v) for v in x[:3]], 3, "ns", "l2")
    assert tqp.get_statistics()["queries_by_type"]["ivf"] == 1


@pytest.mark.parametrize("metric", METRICS)
def test_filtered_search_matches_jax(pair, corpus, metric):
    """filter= on the default config's row-major path (kernel B5 over the filtered
    liveness), before and after deletes: JAX's ids in JAX's order, only matching rows."""
    rng, _, ids, _, queries = corpus
    jqp, tqp = pair
    spec = {"i": {"$gte": N // 2}}
    for when in ("fresh", "deleted"):
        if when == "deleted":
            gone = [ids[i] for i in rng.choice(N, 300, replace=False)]
            assert sorted(map(str, jqp.delete(gone, "ns"))) == sorted(
                map(str, tqp.delete(gone, "ns")))
        jr = jqp.find_similar_batch([JaxDTO(q) for q in queries], 10, "ns", metric,
                                    filter=spec)
        tr = tqp.find_similar_batch([VectorDTO(q) for q in queries], 10, "ns", metric,
                                    filter=spec)
        _assert_same_results(jr, tr)
        assert all(len(r) == 10 and all(h["metadata"]["i"] >= N // 2 for h in r)
                   for r in tr)


def test_scan_backend_config_matches_fused(corpus):
    _, x, ids, _, queries = corpus
    res = []
    for use_fused in (True, False):
        tqp = QueryProcessor(EngineConfig(use_pallas=use_fused), device="cpu")
        tqp.bulk_load(x, "ns", ids=ids)
        res.append(tqp.find_similar_batch([VectorDTO(q) for q in queries], 10, "ns"))
    _assert_same_results(*res)


@pytest.mark.parametrize("use_fused", [True, False])
def test_backend_return_contract(use_fused):
    # (dist, idx), or (dist, idx, tier) when the caller asks for the certificate tier:
    # the row-major path proves the batch at tier 0 (ROADMAP C20), the scan runs no
    # certificate (-1)
    rng = np.random.default_rng(3)
    n = 8192  # two 4096-row tiles: the fused path, not its scan fallback
    data = torch.from_numpy(rng.standard_normal((n, D), dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((8, D), dtype=np.float32))
    sq = (data * data).sum(-1)
    valid = torch.ones(n, dtype=torch.bool)
    backend = knn_backend(EngineConfig(use_pallas=use_fused))
    kw = dict(k=5, metric="l2", db_tile=8192, live_prefix=n)
    d, i = backend(q, data, valid, sq, **kw)
    d3, i3, tier = backend(q, data, valid, sq, report_tier=True, **kw)
    assert tier == (0 if use_fused else -1) and torch.equal(i, i3) and torch.equal(d, d3)
    assert d.shape == i.shape == (8, 5) and i.dtype == torch.int32


def test_storage_engine_matches_jax(corpus):
    _, x, ids, meta, _ = corpus
    jse, tse = JaxStorage(JaxConfig()), StorageEngine(EngineConfig(), device="cpu")
    for se, vec in ((jse, JaxVector), (tse, Vector)):
        se.write_vectors([vec(x[i], meta[i], id=ids[i]) for i in range(6)], "a")
        se.write(vec(x[6], {"solo": True}, id=ids[6]), "b")
    for se in (jse, tse):
        assert se.delete(ids[0], "a") and not se.delete(ids[0], "a")
        assert se.delete_vectors([ids[1], ids[99]], "a") == [ids[1]]
    assert tse.list_namespaces() == jse.list_namespaces() == ["a", "b"]
    assert tse.total_vectors == jse.total_vectors == 5
    assert tse.exists(ids[6]) and not tse.exists(ids[0]) and jse.exists(ids[6])
    got = [v and (v.id, v.metadata) for v in tse.read_vectors([ids[2], ids[0]], "a")]
    want = [v and (v.id, v.metadata) for v in jse.read_vectors([ids[2], ids[0]], "a")]
    assert got == want == [(ids[2], meta[2]), None]
    np.testing.assert_array_equal(tse.read(ids[6], "b").values, x[6])
    assert {v.id for v in tse.iterate_vectors("a")} == {v.id for v in jse.iterate_vectors("a")}
    assert list(tse.iterate_vectors("nope")) == []
    assert {k: len(v) for k, v in tse.namespace_map.items()} == {"a": 4, "b": 1}
    assert tse.delete_vectors([ids[6]], "b") == [ids[6]] and tse.list_namespaces() == ["a"]
    tse.clear_all()
    assert tse.total_vectors == 0 and tse.read(ids[2], "a") is None


@pytest.mark.parametrize("path", ["upsert", "bulk_upsert"])
def test_repeated_id_in_one_write_batch_keeps_the_last_write(path):
    """A write batch that names one id twice ([a: 1.0, b: 2.0, a: 3.0]): the port's device
    row, its squared norm, the hydrated values and the search ranking all follow the last
    write.  The JAX store pads the batch to a power of two by repeating row 0 after its
    host tables took the last write (mlvectordb_tpu/store/namespace.py:637-644), so its
    device row keeps 1.0 while hydration gives 3.0, and its search ranks the stale row: an
    intended divergence (ROADMAP §C)."""
    a, b = uuid.UUID(int=1), uuid.UUID(int=2)
    rows = np.array([[1.0] * 4, [2.0] * 4, [3.0] * 4], np.float32)
    ids = [a, b, a]
    out = {}
    for name, qp, dto in (("jax", JaxQueryProcessor(config=JaxConfig()), JaxDTO),
                          ("port", QueryProcessor(EngineConfig(), device="cpu"), VectorDTO)):
        if path == "upsert":
            qp.upsert_many([dto(r, id=i) for r, i in zip(rows, ids)], "ns")
        else:
            qp.bulk_load(rows, "ns", ids=ids)
        ns = qp.storage.namespace("ns")
        state, slot = ns.device_state(), ns._id_to_slot[a]
        hits = qp.find_similar(dto(np.full(4, 3.0, np.float32)), 2, "ns", "l2")
        out[name] = (float(np.asarray(state.data)[slot, 0]),
                     float(np.asarray(state.sq_norms)[slot]), float(ns.get(a).values[0]),
                     [h["id"] for h in hits])
    assert out["port"] == (3.0, 36.0, 3.0, [a, b])
    assert out["jax"] == (1.0, 4.0, 3.0, [b, a])


def test_package_never_imports_jax():
    """Every module of the port (the filters, the native loader, the probes, and the WAL,
    snapshots, utilities, protocols, index and compat layer, IVF and k-means, the
    micro-batcher and the server copied or ported from the JAX package included, and the
    distribution layer: mesh, sharding, replication, the sharded store and the dry run)
    imports neither jax nor the JAX package, not even its framework-free modules."""
    code = (
        "import importlib, pkgutil, sys, mlvectordb_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "want = ['filters', 'native', 'engine.filters', 'engine.wal', 'engine.persist',\n"
        "        'utils.tracing', 'utils.health', 'utils.metrics', 'utils.capacity',\n"
        "        'interfaces.index', 'interfaces.query_processor',\n"
        "        'interfaces.storage_engine', 'store.index', 'compat', 'ops.kmeans',\n"
        "        'store.ivf', 'engine.batcher', 'api', 'api.rest_api', 'api.grpc_server',\n"
        "        'api.router', 'api.server', 'api.vectordb_pb2', 'parallel',\n"
        "        'parallel.mesh', 'parallel.sharding', 'parallel.replication',\n"
        "        'parallel.store', 'parallel.dryrun']\n"
        "assert {'mlvectordb_tpu_torch.' + m for m in want} <= set(mods), mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mlvectordb_tpu.'))\n"
        "       or m == 'mlvectordb_tpu']\n"
        "sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr


def test_storage_info_reports_device():
    tqp = QueryProcessor(EngineConfig(), device=torch.device("cpu"))
    tqp.bulk_load(np.ones((10, 3), np.float32), "a")
    info = tqp.get_storage_info()
    assert info["device"] == "cpu" and info["total_vectors"] == 10
    assert info["storage_size_bytes"] == 4096 * 128 * 4 + 4096 * 5
