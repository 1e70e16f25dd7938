"""The port's write-ahead log (mlvectordb_tpu_torch/engine/wal.py) and crash recovery
through its QueryProcessor, on the CPU: the cases of tests/test_wal.py, and logs moved
across packages.

The WAL file format is the JAX package's, so a log one package writes replays in the
other with the same rows, metadata and search answers (ids set-exact, scores within 1e-5
relative and 1e-5 absolute: the two scan backends sum in different orders).  The IVF
lifecycle (``build_ivf`` / ``drop_ivf`` records) replays in both with the same index, and
a record whose op a package does not know is skipped and counted as applied in both.
"""

import dataclasses
import os
import shutil
import uuid

import numpy as np
import pytest

from mlvectordb_tpu.engine.query_processor import QueryProcessor as JaxQueryProcessor
from mlvectordb_tpu.engine.wal import WriteAheadLog as JaxWriteAheadLog
from mlvectordb_tpu.interfaces.vector import VectorDTO as JaxDTO
from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.engine.wal import WriteAheadLog

SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128), use_pallas=False)


@pytest.fixture
def cfg():
    return EngineConfig(**SMALL)


def dto(vals, meta=None, vid=None):
    return VectorDTO(values=vals, metadata=meta, id=vid)


def _new(cfg):
    return QueryProcessor(cfg, device="cpu")


def _load(path, cfg, **kw):
    return QueryProcessor.load(path, cfg, device="cpu", **kw)


def test_wal_append_replay_roundtrip(tmp_path, rng):
    wal = WriteAheadLog(str(tmp_path / "wal"))
    ids = [uuid.uuid4() for _ in range(3)]
    vals = rng.standard_normal((3, 8)).astype(np.float32)
    wal.append("upsert", "ns", ids=ids, values=vals, metadatas=[{"i": i} for i in range(3)])
    wal.append("delete", "ns", ids=[ids[0]])
    wal.append("delete_namespace", "other")
    wal.close()

    recs = list(WriteAheadLog.replay(str(tmp_path / "wal")))
    assert [r["op"] for r in recs] == ["upsert", "delete", "delete_namespace"]
    np.testing.assert_array_equal(recs[0]["values"], vals)
    assert recs[0]["ids"] == [str(i) for i in ids]
    assert recs[0]["meta"] == [{"i": 0}, {"i": 1}, {"i": 2}]
    assert recs[2]["ns"] == "other"


def test_wal_torn_tail_dropped(tmp_path, rng):
    wal = WriteAheadLog(str(tmp_path / "wal"))
    wal.append("upsert", "ns", ids=[uuid.uuid4()],
               values=rng.standard_normal((1, 4)).astype(np.float32))
    wal.append("delete", "ns", ids=[uuid.uuid4()])
    wal.close()
    # a crash mid-append: the last record truncated
    full = tmp_path / "wal" / sorted(os.listdir(tmp_path / "wal"))[0]
    data = full.read_bytes()
    full.write_bytes(data[:-7])
    recs = list(WriteAheadLog.replay(str(tmp_path / "wal")))
    assert len(recs) == 1 and recs[0]["op"] == "upsert"
    # a flipped byte inside the first record's payload: the CRC rejects it
    bad = bytearray(data[: len(data) // 2 * 2])
    bad[30] ^= 0xFF
    full.write_bytes(bytes(bad))
    assert list(WriteAheadLog.replay(str(tmp_path / "wal"))) == []


def test_crash_recovery_without_snapshot(tmp_path, cfg, rng):
    """Everything written before a crash (no snapshot ever taken) is recovered."""
    wal_dir = str(tmp_path / "wal")
    qp = _new(cfg)
    qp.enable_wal(wal_dir)
    vs = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32), {"i": i})
                         for i in range(30)], "ns")
    one = qp.insert(dto(rng.standard_normal(8).astype(np.float32), {"solo": True}), "ns")
    qp.delete([vs[0].id, vs[1].id], "ns")
    qp.bulk_load(rng.standard_normal((50, 8)).astype(np.float32), "bulk")
    qp.delete_namespace("bulk")
    # crash: no save(); recover from the WAL alone
    qp2 = _load(str(tmp_path / "nonexistent"), cfg, wal_path=wal_dir)
    assert qp2.get_namespace_count("ns") == 29
    assert qp2.storage.read(vs[0].id, "ns") is None
    got = qp2.storage.read(one.id, "ns")
    assert got is not None and got.metadata == {"solo": True}
    np.testing.assert_array_equal(got.values, one.values)
    assert "bulk" not in qp2.list_namespaces()


def test_snapshot_plus_wal_recovery(tmp_path, cfg, rng):
    """save() seals and prunes the covered segments; only later writes replay."""
    wal_dir, snap = str(tmp_path / "wal"), str(tmp_path / "snap")
    qp = _new(cfg)
    qp.enable_wal(wal_dir)
    pre = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(20)],
                         "ns")
    qp.save(snap)
    segs_after_save = sorted(os.listdir(wal_dir))
    post = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32), {"post": True})
                           for _ in range(5)], "ns")
    qp.delete([pre[3].id], "ns")

    qp2 = _load(snap, cfg, wal_path=wal_dir)
    assert qp2.get_namespace_count("ns") == 24  # 20 - 1 + 5
    assert qp2.storage.read(pre[3].id, "ns") is None
    assert qp2.storage.read(post[0].id, "ns").metadata == {"post": True}
    # the pre-snapshot segment was pruned (covered by the snapshot)
    assert all(int(s.split("_")[1].split(".")[0]) >= 1 for s in segs_after_save)


def _refused_history(qp, make_dto, vals, refused):
    """Acknowledged writes around writes the store refuses: 16-d rows into an 8-d
    namespace, a batch of mixed dims, or growth past max_capacity (64 rows)."""
    before = qp.upsert_many([make_dto(v, {"i": i}) for i, v in enumerate(vals[:20])], "ns")
    if refused == "dim":
        wide = np.concatenate([vals[20:23], vals[23:26]], axis=1)
        with pytest.raises(ValueError, match="dimension mismatch"):
            qp.upsert_many([make_dto(v, None) for v in wide], "ns")
        with pytest.raises(ValueError, match="dimension mismatch"):
            qp.insert(make_dto(wide[0], None), "ns")
        with pytest.raises(ValueError):   # JAX: the log's np.stack refuses the batch
            qp.upsert_many([make_dto(vals[26], None), make_dto(wide[1], None)], "fresh")
    else:
        with pytest.raises(MemoryError, match="max_capacity"):
            qp.upsert_many([make_dto(v, None) for v in vals[30:80]], "ns")
    assert qp.get_namespace_count("ns") == 20
    after = qp.upsert_many([make_dto(v, {"j": j}) for j, v in enumerate(vals[80:90])], "ns")
    qp.delete([before[0].id], "ns")
    return before, after


@pytest.mark.parametrize("refused", ["dim", "capacity"])
def test_refused_write_is_never_logged(tmp_path, small_config, rng, refused):
    """A write the store refuses raises before it is logged, so it is not applied and the
    acknowledged writes on both sides of it recover from the log.  The JAX processor logs
    it before the store refuses it, and its recovery then raises (ROADMAP C7)."""
    vals = rng.standard_normal((90, 8)).astype(np.float32)
    jcfg = dataclasses.replace(small_config, max_capacity=64)
    jwal = str(tmp_path / "jwal")
    jqp = JaxQueryProcessor(config=jcfg)
    jqp.enable_wal(jwal)
    _refused_history(jqp, lambda v, m: JaxDTO(values=v, metadata=m), vals, refused)
    assert len(list(JaxWriteAheadLog.replay(jwal))) > 3
    with pytest.raises((ValueError, MemoryError)):
        JaxQueryProcessor.load(str(tmp_path / "nonexistent"), jcfg, wal_path=jwal)

    cfg = EngineConfig(**{**SMALL, "max_capacity": 64})
    wal_dir = str(tmp_path / "wal")
    qp = _new(cfg)
    qp.enable_wal(wal_dir)
    before, after = _refused_history(qp, dto, vals, refused)
    assert [r["op"] for r in WriteAheadLog.replay(wal_dir)] == ["upsert", "upsert", "delete"]

    qp2 = _load(str(tmp_path / "nonexistent"), cfg, wal_path=wal_dir)
    assert qp2.get_namespace_count("ns") == 29 and "fresh" not in qp2.list_namespaces()
    assert qp2.storage.read(before[0].id, "ns") is None
    for v in before[1:] + after:
        got = qp2.storage.read(v.id, "ns")
        np.testing.assert_array_equal(got.values, v.values)
        assert got.metadata == v.metadata


def test_replay_is_idempotent(tmp_path, cfg, rng):
    wal_dir = str(tmp_path / "wal")
    qp = _new(cfg)
    qp.enable_wal(wal_dir)
    vs = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(10)],
                        "ns")
    qp.delete([vs[9].id], "ns")

    qp2 = _new(cfg)
    assert qp2.replay_wal(wal_dir) == 2
    assert qp2.replay_wal(wal_dir) == 2  # replaying twice changes nothing
    assert qp2.get_namespace_count("ns") == 9
    assert {v.id for v in qp2.get_namespace_vectors("ns")} == {v.id for v in vs[:9]}


def test_wal_search_results_survive_recovery(tmp_path, cfg, rng):
    wal_dir = str(tmp_path / "wal")
    qp = _new(cfg)
    qp.enable_wal(wal_dir)
    qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(40)], "ns")
    q = rng.standard_normal(8).astype(np.float32)
    before = qp.find_similar(dto(q), top_k=5, namespace="ns", metric="l2")

    qp2 = _load(str(tmp_path / "none"), cfg, wal_path=wal_dir)
    after = qp2.find_similar(dto(q), top_k=5, namespace="ns", metric="l2")
    assert [r["id"] for r in before] == [r["id"] for r in after]
    for b, a in zip(before, after):
        assert a["score"] == pytest.approx(b["score"], rel=1e-6)


def test_prune_deferred_until_snapshot_is_final(tmp_path, cfg, rng):
    """_save_snapshot does not prune: a crash between writing a temp snapshot and its
    atomic rename would otherwise lose every record since the previous snapshot."""
    wal_dir = str(tmp_path / "wal")
    qp = _new(cfg)
    qp.enable_wal(wal_dir)
    qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(8)], "ns")

    sealed = qp._save_snapshot(str(tmp_path / "snap.tmp"))
    assert sealed and all(os.path.exists(s) for s in sealed)  # still replayable
    # crash HERE (before the rename): recovery from the old state + WAL sees everything
    qp2 = _load(str(tmp_path / "missing"), cfg, wal_path=wal_dir)
    assert qp2.get_namespace_count("ns") == 8

    qp._wal.prune(sealed)  # what the caller does after the rename
    assert not any(os.path.exists(s) for s in sealed)


@pytest.mark.parametrize("op", ["build_ivf", "drop_ivf"])
def test_wal_ivf_record_raises_naming_a13(tmp_path, small_config, cfg, rng, op):
    """A log the JAX package wrote with the IVF lifecycle (tests/test_wal.py's IVF case;
    the test keeps the name of the refusal it replaced): replayed in both packages, the
    same records applied, the same rows, and after ``build_ivf`` an index of the same
    shape with JAX's centroids (within 1e-5) and JAX's nprobe answers; after
    ``drop_ivf`` no index in either.  A log holding only the op's record, for a namespace
    that does not exist, applies as one record in both (the build skipped with a
    warning)."""
    wal_dir = str(tmp_path / "wal")
    jqp = JaxQueryProcessor(config=small_config)
    jqp.enable_wal(wal_dir)
    vals = rng.standard_normal((300, 8)).astype(np.float32)
    jqp.bulk_load(vals, "ns")
    jqp.build_ivf("ns", n_clusters=8, seed=5)
    if op == "drop_ivf":
        jqp.drop_ivf("ns")
    jrec = JaxQueryProcessor(config=small_config)
    tqp = _new(cfg)
    assert tqp.replay_wal(wal_dir) == jrec.replay_wal(wal_dir) == (2 if op == "build_ivf" else 3)
    assert not tqp._wal_replaying
    _same_store(jrec, tqp, vals[:4], count=300)
    jivf, tivf = jrec.storage.namespace("ns").ivf, tqp.storage.namespace("ns").ivf
    if op == "drop_ivf":
        assert jivf is None and tivf is None
    else:
        assert (tivf.C, tivf.L, tivf.spill) == (jivf.C, jivf.L, jivf.spill)
        np.testing.assert_allclose(tivf.centroids.numpy(), np.asarray(jivf.centroids),
                                   rtol=1e-5, atol=1e-5)
        for nprobe in (2, 8):
            jr = jrec.find_similar_batch([JaxDTO(v) for v in vals[:6]], 5, "ns", "l2",
                                         nprobe=nprobe)
            tr = tqp.find_similar_batch([VectorDTO(v) for v in vals[:6]], 5, "ns", "l2",
                                        nprobe=nprobe)
            assert [[r["id"] for r in a] for a in jr] == [[r["id"] for r in b] for b in tr]
    only = WriteAheadLog(str(tmp_path / "only"))
    only.append(op, "nowhere", params={"n_clusters": 8} if op == "build_ivf" else None)
    only.close()
    assert _new(cfg).replay_wal(str(tmp_path / "only")) == 1
    assert JaxQueryProcessor(config=small_config).replay_wal(str(tmp_path / "only")) == 1


def test_unknown_wal_op_is_skipped_and_counted_like_jax(tmp_path, small_config, cfg, rng):
    """A record with an op this package does not know (a newer writer's) between two
    upserts: both packages skip it, count it as applied and apply the records around it
    (ROADMAP C9)."""
    wal = WriteAheadLog(str(tmp_path / "wal"))
    ids = [uuid.UUID(int=i + 1) for i in range(6)]
    vals = rng.standard_normal((6, 8)).astype(np.float32)
    wal.append("upsert", "ns", ids=ids[:3], values=vals[:3], metadatas=[{"i": i} for i in range(3)])
    wal.append("future_op", "ns", params={"anything": [1, 2]})
    wal.append("upsert", "ns", ids=ids[3:], values=vals[3:], metadatas=[None] * 3)
    wal.close()
    jqp = JaxQueryProcessor(config=small_config)
    tqp = _new(cfg)
    assert tqp.replay_wal(str(tmp_path / "wal")) == jqp.replay_wal(str(tmp_path / "wal")) == 3
    _same_store(jqp, tqp, vals[:2], count=6)


def test_wal_torn_middle_segment_stops_replay(tmp_path, rng):
    """Corruption in a non-final segment stops replay entirely: applying later segments
    over the gap would replay mutations out of order."""
    wal = WriteAheadLog(str(tmp_path / "wal"))
    wal.append("upsert", "a", ids=[uuid.uuid4()],
               values=rng.standard_normal((1, 4)).astype(np.float32))
    wal.rotate()
    wal.append("upsert", "b", ids=[uuid.uuid4()],
               values=rng.standard_normal((1, 4)).astype(np.float32))
    wal.rotate()
    wal.append("upsert", "c", ids=[uuid.uuid4()],
               values=rng.standard_normal((1, 4)).astype(np.float32))
    wal.close()
    seg1 = sorted(f for f in os.listdir(str(tmp_path / "wal")) if f.startswith("wal_"))[1]
    p = str(tmp_path / "wal" / seg1)
    data = bytearray(open(p, "rb").read())
    data[20] ^= 0xFF
    open(p, "wb").write(bytes(data))
    # segment 0 applies; the corrupt segment 1 stops everything, segment 2 is not applied
    assert [r["ns"] for r in WriteAheadLog.replay(str(tmp_path / "wal"))] == ["a"]


def test_wal_only_checkpoint_bounds_growth(tmp_path, cfg, rng):
    """WAL-only mode with checkpoint_bytes: the log is pruned into a checkpoint snapshot,
    and recovery = checkpoint + remaining segments."""
    wal_dir = str(tmp_path / "wal")
    qp = _new(cfg)
    qp.enable_wal(wal_dir, checkpoint_bytes=20_000)
    all_vals = rng.standard_normal((400, 8)).astype(np.float32)
    ids = []
    for lo in range(0, 400, 50):
        ids.extend(qp.bulk_load(all_vals[lo : lo + 50], "ns"))
    assert qp._wal.total_bytes() < 20_000 + 8_000, "log never pruned in WAL-only mode"
    assert os.path.isfile(os.path.join(wal_dir, "checkpoint", "manifest.json"))
    assert qp.get_statistics()["queries_by_type"].get("wal_checkpoint", 0) >= 1
    qp.delete([ids[0]], "ns")

    qp2 = _load(str(tmp_path / "nope"), cfg, wal_path=wal_dir)
    assert qp2.get_namespace_count("ns") == 399
    got = qp2.find_similar(dto(all_vals[5]), top_k=1, namespace="ns", metric="l2")
    assert got[0]["id"] == ids[5] and got[0]["score"] == pytest.approx(0.0, abs=1e-6)


def test_checkpoint_old_fallback_recovers(tmp_path, cfg, rng):
    """A crash between the checkpoint swap's two renames leaves only checkpoint.old;
    recovery falls back to it instead of starting empty."""
    wal_dir = str(tmp_path / "wal")
    qp = _new(cfg)
    qp.enable_wal(wal_dir, checkpoint_bytes=20_000)
    all_vals = rng.standard_normal((400, 8)).astype(np.float32)
    ids = []
    for lo in range(0, 400, 50):
        ids.extend(qp.bulk_load(all_vals[lo : lo + 50], "ns"))
    ckpt = os.path.join(wal_dir, "checkpoint")
    assert os.path.isfile(os.path.join(ckpt, "manifest.json"))

    os.rename(ckpt, ckpt + ".old")   # the torn swap
    qp2 = _load(str(tmp_path / "nope"), cfg, wal_path=wal_dir)
    assert qp2.get_namespace_count("ns") == 400
    got = qp2.find_similar(dto(all_vals[7]), top_k=1, namespace="ns", metric="l2")
    assert got[0]["id"] == ids[7]

    # the same fallback for an explicit snapshot directory torn mid-swap
    snap = str(tmp_path / "snap")
    qp.save(snap)
    shutil.move(snap, snap + ".old")
    assert _load(snap, cfg).get_namespace_count("ns") == 400


# ---- logs across packages -------------------------------------------------------------

def _write_history(qp, make_dto, vals, metas, ids):
    """One history of every logged op: upsert_many, insert, bulk_load, an overwrite,
    delete and delete_namespace."""
    qp.upsert_many([make_dto(v, m, i) for v, m, i in zip(vals[:40], metas[:40], ids[:40])],
                   "ns")
    qp.insert(make_dto(vals[40], {"solo": True}, ids[40]), "ns")
    qp.bulk_load(vals[41:120], "ns", ids=ids[41:120], metadatas=metas[41:120])
    qp.upsert_many([make_dto(vals[120], {"over": 1}, ids[3])], "ns")
    qp.delete([ids[5], ids[50], uuid.UUID(int=999_999)], "ns")
    qp.bulk_load(vals[:10], "gone")
    qp.delete_namespace("gone")


def _same_store(jqp, tqp, queries, count=118):
    assert jqp.list_namespaces() == tqp.list_namespaces() == ["ns"]
    jv = {v.id: v for v in jqp.get_namespace_vectors("ns")}
    tv = {v.id: v for v in tqp.get_namespace_vectors("ns")}
    assert jv.keys() == tv.keys() and len(tv) == count
    for vid, v in tv.items():
        np.testing.assert_array_equal(v.values, jv[vid].values)
        assert v.metadata == jv[vid].metadata
    for metric in ("l2", "ip", "cosine"):
        jr = jqp.find_similar_batch([JaxDTO(q) for q in queries], 10, "ns", metric)
        tr = tqp.find_similar_batch([VectorDTO(q) for q in queries], 10, "ns", metric)
        for a, b in zip(jr, tr):
            assert {r["id"] for r in a} == {r["id"] for r in b}
            np.testing.assert_allclose(sorted(r["score"] for r in b),
                                       sorted(r["score"] for r in a), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_replays_across_packages(tmp_path, small_config, cfg, rng, writer):
    """A log the JAX package wrote replays in the port, and one the port wrote replays in
    the JAX package: the same rows, metadata and search answers as the writer's own
    recovery."""
    wal_dir = str(tmp_path / "wal")
    vals = rng.standard_normal((121, 8)).astype(np.float32)
    metas = [{"i": i, "g": "ab"[i % 2]} for i in range(121)]
    ids = [uuid.UUID(int=i + 1) for i in range(121)]
    queries = rng.standard_normal((4, 8)).astype(np.float32)
    if writer == "jax":
        src = JaxQueryProcessor(config=small_config)
        src.enable_wal(wal_dir)
        _write_history(src, lambda v, m, i: JaxDTO(v, m, id=i), vals, metas, ids)
    else:
        src = _new(cfg)
        src.enable_wal(wal_dir)
        _write_history(src, lambda v, m, i: VectorDTO(v, m, id=i), vals, metas, ids)
    jqp = JaxQueryProcessor.load(str(tmp_path / "none"), small_config, wal_path=wal_dir)
    tqp = _load(str(tmp_path / "none"), cfg, wal_path=wal_dir)
    _same_store(jqp, tqp, queries)
    got = tqp.storage.read(ids[3], "ns")
    np.testing.assert_array_equal(got.values, vals[120])
    assert got.metadata == {"over": 1}
    assert tqp.storage.read(ids[40], "ns").metadata == {"solo": True}


def test_wal_records_are_byte_equal_to_jax(tmp_path, rng):
    """The same appends give byte-identical segment files in both packages."""
    ids = [uuid.UUID(int=i + 7) for i in range(3)]
    vals = rng.standard_normal((3, 5)).astype(np.float32)
    for name, cls in (("jax", JaxWriteAheadLog), ("port", WriteAheadLog)):
        w = cls(str(tmp_path / name))
        w.append("upsert", "ns", ids=ids, values=vals, metadatas=[{"a": 1}, None, {"b": [2]}])
        w.append("delete", "ns", ids=ids[:1])
        w.rotate()
        w.append("delete_namespace", "ns")
        w.close()
    segs = sorted(os.listdir(tmp_path / "jax"))
    assert segs == sorted(os.listdir(tmp_path / "port")) and len(segs) == 2
    for seg in segs:
        assert (tmp_path / "jax" / seg).read_bytes() == (tmp_path / "port" / seg).read_bytes()
