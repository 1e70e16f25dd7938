"""The port's SearchIndex (the IndexProtocol view) and its drop-in compat layer for
reference users, on the CPU: the cases of tests/test_index_compat.py, with each object
asked for the CPU (the port's entry points default to the card), and the protocols'
conformance.  Both objects are also held against the JAX package's on the same inputs:
ids set-exact, scores within 1e-5 relative and 1e-5 absolute (the JAX engine scans with
XLA on the CPU, the port with its own scan or the kernels' plain versions, which sum in
other orders).
"""

import uuid

import numpy as np
import pytest

from mlvectordb_tpu_torch import (
    EngineConfig,
    QueryProcessor,
    QueryProcessorProtocol,
    SearchIndex,
    StorageEngine,
    StorageEngineProtocol,
    Vector,
    VectorDTO,
)
from mlvectordb_tpu_torch.interfaces import SearchIndexProtocol, SearchResultProtocol

SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128), use_pallas=False)


@pytest.fixture
def cfg():
    return EngineConfig(**SMALL)


@pytest.fixture(params=[2, 5, 100])
def corpus(request, rng, cfg):
    # sizes 2/5/100 mirror reference tests/test_index.py:8-17
    vecs = [Vector(rng.standard_normal(16).astype(np.float32)) for _ in range(request.param)]
    idx = SearchIndex(space="l2", config=cfg, device="cpu")
    idx.add(vecs, "ns")
    return idx, vecs


def test_add_then_search_returns_known_ids(corpus, rng):
    idx, vecs = corpus
    q = vecs[0].values + rng.normal(0, 0.01, size=16).astype(np.float32)
    results = idx.search(q, k=3, namespace="ns")
    known = {v.id for v in vecs}
    assert 1 <= len(results) <= 3
    for r in results:
        assert r.vector_id in known
        assert isinstance(r.score, float) and r.score >= 0.0  # l2
        assert isinstance(r, SearchResultProtocol)
    assert results[0].vector_id == vecs[0].id


def test_remove_tombstones_never_surface(corpus):
    idx, vecs = corpus
    idx.remove([vecs[0].id], "ns")
    results = idx.search(vecs[0].values, k=len(vecs), namespace="ns")
    assert vecs[0].id not in [r.vector_id for r in results]


def test_rebuild_keeps_other_namespaces_searchable(rng, cfg):
    """The reference's rebuild destroys every other namespace's index; this one compacts
    only the namespace asked for."""
    idx = SearchIndex(space="l2", config=cfg, device="cpu")
    a = [Vector(rng.standard_normal(8).astype(np.float32)) for _ in range(20)]
    b = [Vector(rng.standard_normal(8).astype(np.float32)) for _ in range(20)]
    idx.add(a, "a")
    idx.add(b, "b")
    idx.remove([v.id for v in a[:10]], "a")
    idx.rebuild("a")
    assert not idx.is_rebuild_required("a")
    assert idx.search(a[15].values, k=1, namespace="a")[0].vector_id == a[15].id
    assert idx.search(b[3].values, k=1, namespace="b")[0].vector_id == b[3].id
    idx.rebuild()   # every namespace, each on its own
    assert idx.search(b[3].values, k=1, namespace="b")[0].vector_id == b[3].id
    assert idx.search(b[3].values, k=1, namespace="missing") == []


@pytest.mark.parametrize("use_fused", [False, True])
def test_metric_selects_distance_at_search_time(rng, use_fused):
    """A metric passed to search() selects the distance; on the fused config the index
    runs the row-major path (the kernels' plain versions on the CPU)."""
    cfg = EngineConfig(**dict(SMALL, use_pallas=use_fused))
    idx = SearchIndex(space="l2", config=cfg, device="cpu")
    vecs = [Vector(rng.standard_normal(8).astype(np.float32)) for _ in range(30)]
    idx.add(vecs, "ns")
    q = rng.standard_normal(8).astype(np.float32)
    cos = idx.search(q, k=5, namespace="ns", metric="cosine")
    db = np.stack([v.values for v in vecs])
    sims = db @ q / (np.linalg.norm(db, axis=1) * np.linalg.norm(q))
    assert [r.vector_id for r in cos] == [vecs[i].id for i in np.argsort(-sims)[:5]]
    assert cos[0].score == pytest.approx(float(sims.max()), rel=1e-4)


def test_protocol_conformance(cfg):
    assert isinstance(SearchIndex(config=cfg, device="cpu"), SearchIndexProtocol)
    assert isinstance(StorageEngine(cfg, device="cpu"), StorageEngineProtocol)
    qp = QueryProcessor(cfg, device="cpu")
    for name in ("insert", "upsert_many", "find_similar", "range_search", "delete"):
        assert callable(getattr(qp, name)) and hasattr(QueryProcessorProtocol, name)


def test_compat_reference_composition_root(cfg):
    """The reference's wiring style (server.py:54) runs unchanged against compat."""
    from mlvectordb_tpu_torch.compat import (
        Index,
        QueryProcessor as CompatQueryProcessor,
        SimpleVector,
        StorageEngineInMemory,
        Vector as CompatVector,
        VectorDTO as CompatDTO,
    )

    qproc = CompatQueryProcessor(StorageEngineInMemory(cfg, device="cpu"),
                                 Index(space="cosine", device="cpu"), device="cpu")
    assert qproc.config.default_metric == "cosine"

    v = qproc.insert(CompatDTO(values=[1.0, 0.0], metadata={"m": 1}), "ns")
    qproc.upsert_many([CompatDTO(values=[0.0, 1.0])], "ns")
    res = qproc.find_similar(CompatDTO(values=[1.0, 0.0]), top_k=1, namespace="ns")
    assert res[0]["id"] == v.id
    assert res[0]["score"] == pytest.approx(1.0, abs=1e-6)  # cosine default from Index

    assert SimpleVector is CompatVector
    sv = SimpleVector([3.0, 4.0])
    assert sv.normalize().values == pytest.approx([0.6, 0.8])
    assert sv.distance(SimpleVector([3.0, 4.0]), metric="l2") == 0.0
    # the storage's config serves when no Index is given; a storage on another device
    # than the processor's is refused
    assert CompatQueryProcessor(StorageEngineInMemory(cfg, device="cpu"),
                                device="cpu").config == cfg
    with pytest.raises(ValueError, match="storage lives on"):
        CompatQueryProcessor(StorageEngineInMemory(cfg, device="cpu"), device="meta")


def test_backup_restore_aliases(rng, cfg, tmp_path):
    qp = QueryProcessor(cfg, device="cpu")
    v = qp.insert(VectorDTO(values=rng.standard_normal(8).astype(np.float32)), "ns")
    qp.create_backup(str(tmp_path / "b"))
    qp.delete([v.id], "ns")
    assert qp.get_namespace_count("ns") == 0
    qp.restore_from_backup(str(tmp_path / "b"))
    assert qp.get_namespace_count("ns") == 1
    assert qp.storage.read(v.id, "ns") is not None
    assert qp.storage.device == qp.device
    qp.save_index(str(tmp_path / "i"))
    qp.load_index(str(tmp_path / "i"))
    assert qp.get_namespace_count("ns") == 1


def test_index_search_with_filter(rng, cfg):
    idx = SearchIndex(space="l2", config=cfg, device="cpu")
    vecs = [Vector(rng.standard_normal(8).astype(np.float32), {"grp": "a" if i % 2 else "b"})
            for i in range(30)]
    idx.add(vecs, "ns")
    q = rng.standard_normal(8).astype(np.float32)
    res = idx.search(q, k=30, namespace="ns", filter={"grp": "a"})
    assert {r.vector_id for r in res} == {v.id for v in vecs if v.metadata["grp"] == "a"}
    assert len(res) == 15  # masked fillers never surface


def _same_hits(jr, tr):
    assert {r.vector_id for r in tr} == {r.vector_id for r in jr}
    want = {r.vector_id: r.score for r in jr}
    for r in tr:
        assert r.score == pytest.approx(want[r.vector_id], rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
def test_search_index_matches_jax(small_config, metric, use_fused):
    """One corpus in the JAX SearchIndex and the port's: the same answers before and
    after deletes (the live prefix is lost), with a filter, and after a rebuild of one
    namespace (the other keeps its tombstones)."""
    from mlvectordb_tpu.store.index import SearchIndex as JaxSearchIndex
    from mlvectordb_tpu.store.vector import Vector as JaxVector

    rng = np.random.default_rng(21)
    n, d = 300, 16
    x = rng.standard_normal((n, d), dtype=np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(n)]
    metas = [{"p": i % 3} for i in range(n)]
    queries = rng.standard_normal((3, d), dtype=np.float32)
    jidx = JaxSearchIndex(space=metric, config=small_config)
    tidx = SearchIndex(space=metric, config=EngineConfig(**dict(SMALL, use_pallas=use_fused)),
                       device="cpu")
    for name in ("ns", "other"):
        jidx.add([JaxVector(x[i], metas[i], id=ids[i]) for i in range(n)], name)
        tidx.add([Vector(x[i], metas[i], id=ids[i]) for i in range(n)], name)

    def check(name, k, **kw):
        for q in queries:
            _same_hits(jidx.search(q, k, name, **kw), tidx.search(q, k, name, **kw))

    check("ns", 10)
    check("ns", 10, filter={"p": 1})
    for name in ("ns", "other"):
        jidx.remove(ids[::4], name)
        tidx.remove(ids[::4], name)
    check("ns", 10)
    check("ns", 60, filter={"p": {"$in": [0, 2]}})
    assert tidx.is_rebuild_required("ns") == jidx.is_rebuild_required("ns")
    jidx.rebuild("ns")
    tidx.rebuild("ns")
    assert not tidx.is_rebuild_required("ns")
    for name in ("ns", "other"):
        check(name, 10)
        check(name, 10, filter={"p": 2})
        check(name, 10, metric="l2")
    assert tidx.search(queries[0], 5, "missing") == jidx.search(queries[0], 5, "missing") == []


@pytest.mark.parametrize("space", ["cosine", "l2", "ip"])
def test_compat_processor_matches_jax(small_config, space):
    """The reference's wiring in both packages, given the same writes: the same default
    metric from the Index and the same answers (result dicts: id, values, metadata,
    score)."""
    from mlvectordb_tpu import compat as jcompat
    from mlvectordb_tpu_torch import compat as tcompat

    rng = np.random.default_rng(22)
    x = rng.standard_normal((120, 8), dtype=np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(120)]
    jq = jcompat.QueryProcessor(jcompat.StorageEngineInMemory(small_config),
                                jcompat.Index(space=space, config=small_config))
    tq = tcompat.QueryProcessor(
        tcompat.StorageEngineInMemory(EngineConfig(**SMALL), device="cpu"),
        tcompat.Index(space=space, config=EngineConfig(**SMALL), device="cpu"), device="cpu")
    assert tq.config.default_metric == jq.config.default_metric == space
    for qp, mod in ((jq, jcompat), (tq, tcompat)):
        qp.insert(mod.VectorDTO(values=x[0], metadata={"i": 0}, id=ids[0]), "ns")
        qp.upsert_many([mod.VectorDTO(values=x[i], metadata={"i": i}, id=ids[i])
                        for i in range(1, 120)], "ns")
        qp.delete(ids[10:30], "ns")
    for q in rng.standard_normal((3, 8), dtype=np.float32):
        jr = jq.find_similar(jcompat.VectorDTO(values=q), top_k=7, namespace="ns")
        tr = tq.find_similar(tcompat.VectorDTO(values=q), top_k=7, namespace="ns")
        assert {r["id"] for r in tr} == {r["id"] for r in jr}
        want = {r["id"]: r for r in jr}
        for r in tr:
            assert r["score"] == pytest.approx(want[r["id"]]["score"], rel=1e-5, abs=1e-5)
            np.testing.assert_array_equal(r["values"], want[r["id"]]["values"])
            assert r["metadata"] == want[r["id"]]["metadata"]
    assert tq.get_namespace_count("ns") == jq.get_namespace_count("ns") == 100
