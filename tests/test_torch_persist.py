"""Snapshots of the port (mlvectordb_tpu_torch/engine/persist.py) on the CPU: the
persistence cases of tests/test_engine.py (round trip, auto-snapshot, the ``.old``
fallback) and snapshots moved across packages.

The format is the JAX package's: a snapshot one package saves loads in the other, for the
default f32 store, ``sweep_dtype="bfloat16"`` and ``dtype="bfloat16"``, with the same
rows, ids and metadata (equal) and the same search answers: ids set-exact, scores within
1e-5 relative and 1e-5 absolute.  The JAX side searches as its own engine tests do (its
scan backend on the CPU); the port's runs its fused paths (the kernels' plain versions),
the certified sweep included.  A namespace's IVF index travels with it, in both
directions.
"""

import json
import os
import shutil
import time
import uuid

import numpy as np
import pytest
import torch

from mlvectordb_tpu.config import EngineConfig as JaxConfig
from mlvectordb_tpu.engine.persist import load_storage as jax_load_storage
from mlvectordb_tpu.engine.query_processor import QueryProcessor as JaxQueryProcessor
from mlvectordb_tpu.interfaces.vector import VectorDTO as JaxDTO
from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, StorageEngine, VectorDTO
from mlvectordb_tpu_torch.engine.persist import load_storage, resolve_snapshot_dir

SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128), use_pallas=False)
# the configs moved across packages; 6,000 rows in an 8,192-row capacity put the port's
# bf16 mirror on the certified sweep (two 4,096-row tiles).  The JAX engine serves its scan
# on the CPU, and a bf16 store's scan ranks bf16(q) . row in both packages (the fused
# paths rescan with the f32 query), so the bf16 store is held to JAX's on the scan (its
# fused path is held to JAX's in tests/test_torch_bf16.py)
CROSS = {
    "f32": {},
    "sweep_bf16": {"sweep_dtype": "bfloat16"},
    "bf16_store": {"dtype": "bfloat16", "use_pallas": False},
}
N_CROSS, D_CROSS = 6000, 48


@pytest.fixture
def qp():
    return QueryProcessor(EngineConfig(**SMALL), device="cpu")


def dto(vals, meta=None, vid=None):
    return VectorDTO(values=vals, metadata=meta, id=vid)


def test_snapshot_roundtrip(qp, rng, tmp_path):
    vs = qp.upsert_many(
        [dto(rng.standard_normal(8).astype(np.float32), {"i": i}) for i in range(25)], "ns")
    qp.insert(dto([1.0, 2.0], {"other": True}), "ns2")
    qp.save(str(tmp_path / "snap"))

    qp2 = QueryProcessor.load(str(tmp_path / "snap"), qp.config, device="cpu")
    assert sorted(qp2.list_namespaces()) == ["ns", "ns2"]
    assert qp2.get_namespace_count("ns") == 25
    got = qp2.storage.read(vs[7].id, "ns")
    np.testing.assert_array_equal(got.values, vs[7].values)
    assert got.metadata == {"i": 7}
    res = qp2.find_similar(dto(vs[3].values), top_k=1, namespace="ns", metric="l2")
    assert res[0]["id"] == vs[3].id


def test_auto_snapshot_roundtrip(qp, rng, tmp_path):
    qp.upsert_many(
        [dto(rng.standard_normal(8).astype(np.float32), {"i": i}) for i in range(10)], "ns")
    snap = str(tmp_path / "auto")
    qp.start_auto_snapshot(snap, interval_s=0.2)
    try:
        deadline = time.time() + 10
        while not os.path.isdir(snap) and time.time() < deadline:
            time.sleep(0.05)
        assert os.path.isdir(snap)
        # mutate and wait for a second snapshot generation
        qp.insert(dto([9.0] * 8, {"late": True}), "ns")
        count0 = qp.get_statistics()["queries_by_type"].get("auto_snapshot", 0)
        deadline = time.time() + 10
        while (qp.get_statistics()["queries_by_type"].get("auto_snapshot", 0) <= count0
               and time.time() < deadline):
            time.sleep(0.05)
    finally:
        qp.stop_auto_snapshot()

    qp2 = QueryProcessor.load(snap, qp.config, device="cpu")
    assert qp2.get_namespace_count("ns") == 11
    res = qp2.find_similar(dto([9.0] * 8), top_k=1, namespace="ns", metric="l2")
    assert res[0]["metadata"] == {"late": True}
    # a finished snapshot replaced the directory atomically: no temp or old copy left
    assert not os.path.exists(snap + ".tmp") and not os.path.exists(snap + ".old")

    with pytest.raises(RuntimeError):
        qp.start_auto_snapshot(snap, 0.2)
        qp.start_auto_snapshot(snap, 0.2)
    qp.stop_auto_snapshot()


def test_snapshot_old_fallback(qp, rng, tmp_path):
    """A crash between the swap's two renames leaves only ``<path>.old``: load and
    resolve_snapshot_dir fall back to it; a directory with neither is no snapshot."""
    vs = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(12)],
                        "ns")
    snap = str(tmp_path / "snap")
    qp.save(snap)
    assert resolve_snapshot_dir(snap) == snap
    shutil.move(snap, snap + ".old")
    assert resolve_snapshot_dir(snap) == snap + ".old"
    qp2 = QueryProcessor.load(snap, qp.config, device="cpu")
    assert {v.id for v in qp2.get_namespace_vectors("ns")} == {v.id for v in vs}
    assert resolve_snapshot_dir(str(tmp_path / "nothing")) is None
    assert resolve_snapshot_dir(None) is None


def test_load_storage_target_engine_and_format(qp, rng, tmp_path):
    qp.bulk_load(rng.standard_normal((20, 8)).astype(np.float32), "ns")
    snap = str(tmp_path / "snap")
    qp.save(snap)
    # restore into a given empty engine: its device applies
    target = StorageEngine(qp.config, device="cpu")
    assert load_storage(snap, qp.config, target) is target
    assert target.list_namespaces() == ["ns"] and target.total_vectors == 20
    assert target.namespace("ns").device == torch.device("cpu")
    with pytest.raises(ValueError, match="must be empty"):
        load_storage(snap, qp.config, target)
    with open(os.path.join(snap, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["format"] = "something-else"
    with open(os.path.join(snap, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="not a snapshot"):
        load_storage(snap, qp.config, device="cpu")


def test_ivf_snapshot_entry_raises_naming_a13(small_config, rng, tmp_path):
    """Snapshots holding a trained IVF index move across packages in both directions (the
    test keeps the name of the refusal it replaced): the loading package restores the
    same layout (every id in its slot, the centroids bit-equal) without retraining and
    answers nprobe searches with the saving package's ids; the namespace without an
    index loads without one."""
    vals = rng.standard_normal((300, 8)).astype(np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(300)]
    other = rng.standard_normal((10, 8)).astype(np.float32)
    queries = vals[:6] + 0.01
    jqp = JaxQueryProcessor(config=small_config)
    tqp = QueryProcessor(EngineConfig(**SMALL), device="cpu")
    for qp in (jqp, tqp):
        qp.bulk_load(vals, "ns", ids=ids)
        qp.bulk_load(other, "plain")
    jqp.build_ivf("ns", n_clusters=8, seed=5, spill=2)
    tqp.build_ivf("ns", n_clusters=8, seed=5, spill=2)
    jqp.save(str(tmp_path / "jax"))
    tqp.save(str(tmp_path / "port"))
    with open(tmp_path / "jax" / "manifest.json") as f:
        jman = json.load(f)
    with open(tmp_path / "port" / "manifest.json") as f:
        assert json.load(f)["namespaces"] == jman["namespaces"]
    loaded = {"jax_to_port": QueryProcessor.load(str(tmp_path / "jax"), EngineConfig(**SMALL),
                                                 device="cpu"),
              "port_to_jax": JaxQueryProcessor.load(str(tmp_path / "port"), small_config)}
    for direction, dst in loaded.items():
        src = jqp if direction == "jax_to_port" else tqp
        sivf, divf = src.storage.namespace("ns").ivf, dst.storage.namespace("ns").ivf
        assert divf._id_to_slot == sivf._id_to_slot and divf._extra_slots == sivf._extra_slots
        np.testing.assert_array_equal(np.asarray(divf.centroids), np.asarray(sivf.centroids))
        assert dst.storage.namespace("plain").ivf is None
        for nprobe in (1, 2, 8):
            for metric in ("l2", "cosine"):
                want = src.find_similar_batch(_dtos(src, queries), 5, "ns", metric,
                                              nprobe=nprobe)
                got = dst.find_similar_batch(_dtos(dst, queries), 5, "ns", metric,
                                             nprobe=nprobe)
                assert [[r["id"] for r in a] for a in want] == [[r["id"] for r in b] for b in got]
                np.testing.assert_allclose([r["score"] for a in got for r in a],
                                           [r["score"] for a in want for r in a],
                                           rtol=1e-5, atol=1e-5)


def _dtos(qp, queries):
    """The queries as DTOs of ``qp``'s package."""
    cls = JaxDTO if isinstance(qp, JaxQueryProcessor) else VectorDTO
    return [cls(q) for q in queries]


def _cross_corpus():
    rng = np.random.default_rng(77)
    x = rng.standard_normal((N_CROSS, D_CROSS), dtype=np.float32)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, N_CROSS)]
    metas = [{"i": i, "p": i % 3} for i in range(N_CROSS)]
    queries = rng.standard_normal((8, D_CROSS), dtype=np.float32)
    return x, ids, metas, queries


def _fill(qp, make_dto, x, ids, metas):
    """Ingest, overwrite 50 ids, delete 300: a store with tombstones and moved values."""
    qp.bulk_load(x, "ns", ids=ids, metadatas=metas)
    qp.upsert_many([make_dto(x[i] * 0.5, {"over": i}, ids[i]) for i in range(50)], "ns")
    qp.delete(ids[1000:1300], "ns")
    qp.insert(make_dto(np.ones(D_CROSS, np.float32), None, uuid.UUID(int=5)), "other")


def _assert_same(jqp, tqp, queries):
    assert sorted(jqp.list_namespaces()) == sorted(tqp.list_namespaces()) == ["ns", "other"]
    for name in ("ns", "other"):
        jv = {v.id: v for v in jqp.get_namespace_vectors(name)}
        tv = {v.id: v for v in tqp.get_namespace_vectors(name)}
        assert jv.keys() == tv.keys()
        for vid, v in tv.items():
            np.testing.assert_array_equal(v.values, jv[vid].values)
            assert v.metadata == jv[vid].metadata
    for metric in ("l2", "ip", "cosine"):
        for flt in (None, {"p": 1}):
            jr = jqp.find_similar_batch([JaxDTO(q) for q in queries], 10, "ns", metric,
                                        filter=flt)
            tr = tqp.find_similar_batch([VectorDTO(q) for q in queries], 10, "ns", metric,
                                        filter=flt)
            for a, b in zip(jr, tr):
                assert len(b) == 10 and {r["id"] for r in a} == {r["id"] for r in b}
                np.testing.assert_allclose(sorted(r["score"] for r in b),
                                           sorted(r["score"] for r in a),
                                           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("name", list(CROSS))
def test_snapshot_moves_across_packages(tmp_path, name, direction):
    """A snapshot one package saves loads in the other with the same rows and answers as
    in the package that saved it; the two packages' snapshots of the same writes are the
    same files."""
    x, ids, metas, queries = _cross_corpus()
    kw = dict(CROSS[name], initial_capacity=8192)
    jcfg, tcfg = JaxConfig(**kw), EngineConfig(**kw)
    jsrc = JaxQueryProcessor(config=jcfg)
    tsrc = QueryProcessor(tcfg, device="cpu")
    _fill(jsrc, lambda v, m, i: JaxDTO(v, m, id=i), x, ids, metas)
    _fill(tsrc, lambda v, m, i: VectorDTO(v, m, id=i), x, ids, metas)
    jsnap, tsnap = str(tmp_path / "jax"), str(tmp_path / "port")
    jsrc.save(jsnap)
    tsrc.save(tsnap)
    assert sorted(os.listdir(jsnap)) == sorted(os.listdir(tsnap))
    for f in sorted(os.listdir(jsnap)):
        if f.endswith(".npz"):
            with np.load(os.path.join(jsnap, f)) as a, np.load(os.path.join(tsnap, f)) as b:
                np.testing.assert_array_equal(a["values"], b["values"])
        else:
            with open(os.path.join(jsnap, f)) as a, open(os.path.join(tsnap, f)) as b:
                assert json.load(a) == json.load(b), f

    # both packages load the writer's files (a bf16 store's snapshot holds its rounded
    # rows, so a loaded store hydrates those where its writer kept the written values)
    snap = jsnap if direction == "jax_to_port" else tsnap
    jqp = JaxQueryProcessor(jax_load_storage(snap, jcfg), jcfg)
    tqp = QueryProcessor.load(snap, tcfg, device="cpu")
    ns = tqp.storage.namespace("ns")
    if name == "sweep_bf16":
        assert ns.device_state().mirror is not None and ns.capacity == 8192
    _assert_same(jqp, tqp, queries)
    if name == "sweep_bf16":
        # the loaded store served the certified sweep, its proof at tier 0
        tiers = tqp.cert_tier_counts("ns")
        assert tiers and set(tiers) <= {"light_fast", "fast"}, tiers
