"""Offload of a cold namespace to host memory in the port, on the CPU: the cases of
tests/test_offload.py (without its sharded and REST ones), held to the JAX package's
behaviour where both have it.

``offload`` moves data, valid and sq_norms to host tensors and drops every device array;
``ensure_resident`` (the first search or write) uploads them, rebuilds the sweep arrays
from the rows and publishes a new snapshot; neither bumps the version.  The rebuilt
mirror and certificate arrays are bit-equal to the ones the writes kept.
"""

import uuid

import numpy as np
import pytest
import torch

from mlvectordb_tpu.engine.query_processor import QueryProcessor as JaxQueryProcessor
from mlvectordb_tpu.interfaces.vector import VectorDTO as JaxDTO
from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO

SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128), use_pallas=False)


def dto(vals, meta=None, vid=None):
    return VectorDTO(values=vals, metadata=meta, id=vid)


@pytest.fixture
def qp():
    return QueryProcessor(EngineConfig(**SMALL), device="cpu")


def test_offload_frees_device_and_search_pages_in(qp, rng, oracle):
    vs = qp.upsert_many(
        [dto(rng.standard_normal(8).astype(np.float32), {"i": i}) for i in range(50)], "cold")
    ns = qp.storage.namespace("cold")
    version = ns.version
    assert qp.offload_namespace("cold") is True
    assert ns.offloaded and ns._data is None and ns._state is None
    assert qp.offload_namespace("cold") is False  # already offloaded
    assert qp.offload_namespace("ghost") is False
    assert ns.nbytes == ns.capacity * (ns.dpad * 4 + 1 + 4)   # the host copy's bytes

    # host-table reads work while offloaded (no page-in)
    got = qp.storage.read(vs[7].id, "cold")
    assert got is not None and got.metadata == {"i": 7}
    assert ns.offloaded

    # the first search pages it back in; results oracle-exact
    q = rng.standard_normal(8).astype(np.float32)
    db = np.stack([v.values for v in vs])
    _, oidx = oracle(q[None, :], db, 5, "l2")
    res = qp.find_similar(dto(q), top_k=5, namespace="cold", metric="l2")
    assert [r["id"] for r in res] == [vs[i].id for i in oidx[0]]
    assert not ns.offloaded and ns.version == version


def test_offload_then_write_pages_in_without_data_loss(qp, rng):
    vs = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(30)],
                        "cold")
    qp.offload_namespace("cold")
    # a write while offloaded restores first (it does not reallocate fresh zeros)
    extra = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32))], "cold")
    assert qp.get_namespace_count("cold") == 31
    res = qp.find_similar(dto(vs[3].values), top_k=1, namespace="cold", metric="l2")
    assert res[0]["id"] == vs[3].id and res[0]["score"] < 1e-6
    res = qp.find_similar(dto(extra[0].values), top_k=1, namespace="cold", metric="l2")
    assert res[0]["id"] == extra[0].id
    # a delete and a compaction page in too
    qp.offload_namespace("cold")
    assert qp.delete([vs[0].id], "cold") == [vs[0].id]
    qp.offload_namespace("cold")
    qp.storage.namespace("cold").compact()
    assert qp.get_namespace_count("cold") == 30


_MIRRORS = {
    "bf16_mirror": dict(sweep_dtype="bfloat16"),
    "bf16_mirror_no_resid": dict(sweep_dtype="bfloat16", sweep_resid=False),
    "int8_mirror": dict(sweep_dtype="int8"),
    "int8_one_stream": dict(sweep_dtype="int8", sweep_resid=False),
    "f32_mirror": dict(sweep_dtype="float32"),
    "bf16_store_same_dtype": dict(dtype="bfloat16", sweep_dtype="bfloat16"),
}


@pytest.mark.parametrize("name", list(_MIRRORS))
def test_offload_with_sweep_mirror_rebuilds_it(rng, name):
    """Every sweep array the writes kept (mirror, residual codes, scales, error norms)
    is dropped by offload and rebuilt bit-equal from the rows on the way back; a mirror of
    the rows' own type is the data tensor again; the searches answer as before."""
    cfg = EngineConfig(initial_capacity=8192, **_MIRRORS[name])
    qp = QueryProcessor(cfg, device="cpu")
    x = rng.standard_normal((6000, 40)).astype(np.float32)
    ids = qp.bulk_load(x[:3000], "ns", batch_rows=1000)
    qp.upsert_many([dto(v) for v in x[3000:3100]], "ns")
    qp.delete(ids[:40], "ns")
    ns = qp.storage.namespace("ns")
    before = ns.device_state()
    queries = [dto(v) for v in rng.standard_normal((4, 40)).astype(np.float32)]
    want = qp.find_similar_batch(queries, 10, "ns", "l2")
    nbytes = ns.nbytes
    qp.offload_namespace("ns")
    assert ns._mirror is None and all(t is None for t in ns._sweep_arrays())
    assert qp.restore_namespace("ns") is True and qp.restore_namespace("ns") is False
    after = ns.device_state()
    assert after is not before and after.prep_cache == {} and ns.nbytes == nbytes
    for field in ("data", "valid", "sq_norms", "mirror", "sweep_err", "sweep_resid",
                  "sweep_rscale", "sweep_err1", "sweep_rscale2"):
        a, b = getattr(before, field), getattr(after, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), field
    if name in ("f32_mirror", "bf16_store_same_dtype"):
        assert after.mirror is after.data
    qp._result_cache.clear()
    got = qp.find_similar_batch(queries, 10, "ns", "l2")
    assert [[r["id"] for r in rs] for rs in got] == [[r["id"] for r in rs] for rs in want]


def test_storage_info_reports_offloaded_like_jax(qp, small_config, rng):
    jqp = JaxQueryProcessor(config=small_config)
    x = rng.standard_normal((10, 8)).astype(np.float32)
    for p, make in ((jqp, JaxDTO), (qp, VectorDTO)):
        p.upsert_many([make(v) for v in x[:5]], "a")
        p.upsert_many([make(v) for v in x[5:]], "b")
        p.offload_namespace("a")
    for p in (jqp, qp):
        info = p.get_storage_info()
        assert info["offloaded_namespaces"] == ["a"]
        assert info["total_vectors"] == 10  # counts unaffected
    # the offloaded namespace counts its host copy: the same bytes in both packages
    assert (qp.storage.namespace("a").nbytes == jqp.storage.namespace("a").nbytes
            == 64 * (128 * 4 + 5))
    assert qp.restore_namespace("a") is True
    assert qp.get_storage_info()["offloaded_namespaces"] == []


def test_offloaded_namespace_snapshots_explains_and_filters_without_surprises(qp, rng,
                                                                              tmp_path):
    vs = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32), {"g": i % 2})
                         for i in range(40)], "ns")
    qp.offload_namespace("ns")
    ns = qp.storage.namespace("ns")
    # a snapshot reads the host copy; explain reads the store's attributes: no page-in
    qp.save(str(tmp_path / "snap"))
    plan = qp.explain_query(dto(vs[0].values), 5, "ns")
    assert ns.offloaded and plan["live_vectors"] == 40
    loaded = QueryProcessor.load(str(tmp_path / "snap"), qp.config, device="cpu")
    assert {v.id for v in loaded.get_namespace_vectors("ns")} == {v.id for v in vs}
    # a filtered search pages in and sees only matching rows
    res = qp.find_similar(dto(vs[4].values), 40, "ns", "l2", filter={"g": 0})
    assert not ns.offloaded and len(res) == 20 and res[0]["id"] == vs[4].id
    assert all(r["metadata"]["g"] == 0 for r in res)


def test_bf16_store_reads_the_written_values_even_offloaded(rng):
    """A bf16 store keeps the written f32 values on the host: hydration and reads return
    them exactly, before and after an offload, while the device holds rounded rows."""
    cfg = EngineConfig(**SMALL, dtype="bfloat16")
    x = rng.standard_normal((30, 8)).astype(np.float32)
    qp = QueryProcessor(cfg, device="cpu")
    ids = qp.bulk_load(x, "ns", metadatas=[{"i": i} for i in range(30)])
    ns = qp.storage.namespace("ns")
    assert ns.device_state().data.dtype == torch.bfloat16
    hit = qp.find_similar(dto(x[7]), 1, "ns", "l2")[0]
    assert hit["id"] == ids[7]
    np.testing.assert_array_equal(hit["values"], x[7])
    qp.offload_namespace("ns")
    got = qp.storage.read(ids[7], "ns")
    np.testing.assert_array_equal(got.values, x[7])
    assert got.metadata == {"i": 7} and ns.offloaded


@pytest.mark.parametrize("store", [
    {},
    {"dtype": "bfloat16", "sweep_dtype": "bfloat16"},
], ids=["f32", "bf16_store_same_dtype"])
def test_offloaded_snapshot_divergence_matches_jax_files(small_config, rng, tmp_path, store):
    """ROADMAP C8, an intended divergence: saving an offloaded namespace pages it back in
    in the JAX package and leaves it offloaded in the port (no device memory spent on a
    snapshot).  The files are the same: each namespace's .npz arrays and .json are equal
    between the two snapshot directories, and each package loads the other's."""
    import dataclasses
    import json

    jcfg = dataclasses.replace(small_config, **store)
    tcfg = EngineConfig(**SMALL, **store)
    x = rng.standard_normal((150, 8)).astype(np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(150)]
    metas = [{"i": i, "g": "ab"[i % 2]} for i in range(150)]
    jqp, tqp = JaxQueryProcessor(config=jcfg), QueryProcessor(tcfg, device="cpu")
    for p in (jqp, tqp):
        p.bulk_load(x, "cold", ids=ids, metadatas=metas)
        p.delete(ids[10:20], "cold")
        p.bulk_load(x[:7] * 2, "warm", ids=ids[:7])
        assert p.offload_namespace("cold")
    jqp.save(str(tmp_path / "jax"))
    tqp.save(str(tmp_path / "port"))
    assert not jqp.storage.namespace("cold").offloaded       # JAX paged it in
    assert tqp.storage.namespace("cold").offloaded            # the port did not
    manifests = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "manifest.json") as f:
            manifests[side] = json.load(f)
    assert manifests["jax"]["namespaces"] == manifests["port"]["namespaces"]
    for entry in manifests["jax"]["namespaces"]:
        base = entry["file"]
        with np.load(tmp_path / "jax" / f"{base}.npz") as a, \
                np.load(tmp_path / "port" / f"{base}.npz") as b:
            assert sorted(a.files) == sorted(b.files) == ["values"]
            assert a["values"].dtype == b["values"].dtype == np.float32
            np.testing.assert_array_equal(a["values"], b["values"])
        with open(tmp_path / "jax" / f"{base}.json") as fa, \
                open(tmp_path / "port" / f"{base}.json") as fb:
            assert json.load(fa) == json.load(fb)
    jl = JaxQueryProcessor.load(str(tmp_path / "port"), jcfg)
    tl = QueryProcessor.load(str(tmp_path / "jax"), tcfg, device="cpu")
    for name in ("cold", "warm"):
        # the stored rows (bf16-rounded in a bf16 store) and the metadata, in both
        jv = {v.id: v for v in jl.get_namespace_vectors(name)}
        tv = {v.id: v for v in tl.get_namespace_vectors(name)}
        src = {v.id: v for v in tqp.get_namespace_vectors(name)}
        assert jv.keys() == tv.keys() == src.keys()
        for vid, v in tv.items():
            np.testing.assert_array_equal(v.values, jv[vid].values)
            assert v.metadata == jv[vid].metadata == src[vid].metadata
    q = x[30]
    a = jl.find_similar(JaxDTO(q), 5, "cold", "l2")
    b = tl.find_similar(dto(q), 5, "cold", "l2")
    assert [r["id"] for r in a] == [r["id"] for r in b] and b[0]["id"] == ids[30]
