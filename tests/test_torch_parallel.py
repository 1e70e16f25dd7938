"""The port's distribution layer (mlvectordb_tpu_torch/parallel) against the JAX package's
in one process: JAX's 8-device CPU mesh (tests/conftest.py) beside the port's mesh of
``[cpu] * 8``, fed the same numpy inputs from a seed.

Every case of tests/test_parallel.py has its counterpart here, plus parity cases: the
sharded search on (2, 4) and (1, 8) meshes for l2, ip and cosine with and without a
bf16 sweep mirror, the slot layout of the same writes, snapshots across the packages,
``convert.sharded_from_jax``, the cluster-sharded IVF probe, a filtered sharded search
run twice (each shard keeps its own prep), the live-row search against the full one, and
ROADMAP C12 (the JAX package's free-space count can hand out a slot twice).  Distances
are held to JAX's ``rtol=2e-4, atol=2e-4`` (tests/test_parallel.py:66) with equal id
sets.  The replication cases are in tests/test_torch_replication.py.
"""

import uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlvectordb_tpu import VectorDTO as JVectorDTO
from mlvectordb_tpu.config import EngineConfig as JEngineConfig
from mlvectordb_tpu.parallel import (ShardingManager as JShardingManager,
                                     build_mesh as jbuild_mesh,
                                     make_distributed_processor as jmake)
from mlvectordb_tpu_torch import EngineConfig, VectorDTO
from mlvectordb_tpu_torch.ops.distances import MASKED
from mlvectordb_tpu_torch.parallel import (ShardingManager, build_mesh,
                                           make_distributed_processor)

CPU8 = [torch.device("cpu")] * 8
SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128), use_pallas=False)
RTOL = ATOL = 2e-4   # JAX's own tolerance for the sharded search (test_parallel.py:66)


@pytest.fixture
def port_small():
    return EngineConfig(**SMALL)


def pmake(r, s, cfg, **kw):
    return make_distributed_processor(r, s, cfg, devices=CPU8[: r * s], **kw)


def dto(vals, meta=None, vid=None):
    return VectorDTO(values=vals, metadata=meta, id=vid)


def jdto(vals, meta=None, vid=None):
    return JVectorDTO(values=vals, metadata=meta, id=vid)


def _same_results(got, want, rtol=RTOL, atol=ATOL):
    """Equal id sets per query and scores within the tolerance (JAX's result dicts)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {r["id"] for r in g} == {r["id"] for r in w}
        np.testing.assert_allclose([r["score"] for r in g], [r["score"] for r in w],
                                   rtol=rtol, atol=atol)


# ---------------------------------------------------------------- test_parallel.py cases

def test_mesh_shapes():
    m = build_mesh(2, 4, devices=CPU8)
    assert m.shape == {"replica": 2, "shard": 4} == dict(jbuild_mesh(2, 4).shape)
    m = build_mesh(1, devices=CPU8)
    assert m.shape == {"replica": 1, "shard": 8}
    with pytest.raises(ValueError):
        build_mesh(3, devices=CPU8)
    with pytest.raises(ValueError, match="needs 16 devices"):
        build_mesh(2, 8, devices=CPU8)
    if not torch.cuda.is_available():   # the default is the visible CUDA devices
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_mesh(1, 1)


def test_shard_routing_deterministic():
    sm = ShardingManager(build_mesh(2, 4, devices=CPU8))
    jsm = JShardingManager(jbuild_mesh(2, 4))
    assert sm.all_shards() == [0, 1, 2, 3] == jsm.all_shards()
    vid = uuid.uuid4()
    assert sm.shard_for_id(vid) == sm.shard_for_id(vid)
    assert 0 <= sm.shard_for_id(vid) < 4
    counts = [0] * 4
    for _ in range(256):
        v = uuid.uuid4()
        assert sm.shard_for_id(v) == jsm.shard_for_id(v)   # bit for bit JAX's routing
        counts[sm.shard_for_id(v)] += 1
    assert all(c > 20 for c in counts)


def _jax_sharded(jsm, q, db, valid, sq, k, metric, mirror=False):
    """JAX's sharded_knn over the same global arrays (with its bf16 sweep mirror and
    sweep_err when ``mirror``)."""
    data, v, n = jsm.place_database(jnp.asarray(db), jnp.asarray(valid), jnp.asarray(sq))
    extra = ()
    if mirror:
        from mlvectordb_tpu.ops.pallas_knn_t import to_sweep_layout

        shard_cap = db.shape[0] // jsm.n_shards
        dt = jax.device_put(to_sweep_layout(data, dtype=jnp.bfloat16, shard_cap=shard_cap),
                            jsm.db_sharding_2d_t())
        d32 = data.astype(jnp.float32)
        err = jnp.sqrt(jnp.sum((d32 - d32.astype(jnp.bfloat16).astype(jnp.float32)) ** 2, -1))
        extra = (dt, jax.device_put(err, jsm.db_sharding()))
    d, i = jsm.sharded_knn(jnp.asarray(q), data, v, n, *extra, k=k, metric=metric)
    return np.asarray(d), np.asarray(i)


def _port_sharded(sm, q, db, valid, sq, k, metric, mirror=False, **kw):
    from mlvectordb_tpu_torch.ops.fused_knn_t import sweep_err_norms

    data = torch.from_numpy(db)
    m = e = None
    if mirror:
        m, e = data.to(torch.bfloat16), sweep_err_norms(data)
    shards = sm.place_database(data, torch.from_numpy(valid), torch.from_numpy(sq), m, e)
    d, i = sm.sharded_knn(torch.from_numpy(q), shards, k=k, metric=metric, **kw)
    return d.numpy(), i.numpy()


def test_sharded_knn_matches_single_device(rng, oracle):
    sm = ShardingManager(build_mesh(2, 4, devices=CPU8))
    N, D, B, K = 1024, 64, 8, 5
    db = rng.standard_normal((N, D), dtype=np.float32)
    q = rng.standard_normal((B, D), dtype=np.float32)
    sq = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    d, i = _port_sharded(sm, q, db, np.ones(N, bool), sq, K, "l2", db_tile=256)
    o_dist, o_idx = oracle(q, db, K, "l2")
    np.testing.assert_allclose(d, o_dist, rtol=RTOL, atol=ATOL)
    for b in range(B):
        assert set(i[b].tolist()) == set(o_idx[b].tolist())


def test_sharded_knn_respects_tombstones(rng):
    sm = ShardingManager(build_mesh(2, 4, devices=CPU8))
    N, D = 512, 32
    db = rng.standard_normal((N, D), dtype=np.float32)
    sq = (db ** 2).sum(-1)
    q = db[:4] + 0.001
    valid = np.ones(N, bool)
    valid[0] = False
    _d, i = _port_sharded(sm, q, db, valid, sq, 3, "l2", db_tile=128)
    assert 0 not in i[0].tolist()


def test_distributed_processor_end_to_end(rng, port_small, small_config):
    """The JAX case through the port, and the JAX processor's answers on the same ids."""
    qp, jqp = pmake(2, 4, port_small), jmake(2, 4, small_config)
    rows = [rng.standard_normal(16).astype(np.float32) for _ in range(200)]
    vs = qp.upsert_many([dto(r, {"i": i}) for i, r in enumerate(rows)], "ns")
    jqp.upsert_many([jdto(r, {"i": i}, v.id) for i, (r, v) in enumerate(zip(rows, vs))], "ns")
    assert qp.get_namespace_count("ns") == 200

    res = qp.find_similar(dto(vs[42].values), top_k=3, namespace="ns", metric="l2")
    assert res[0]["id"] == vs[42].id
    assert res[0]["score"] == pytest.approx(0.0, abs=1e-5)

    q = rng.standard_normal(16).astype(np.float32)
    res = qp.find_similar(dto(q), top_k=10, namespace="ns", metric="cosine")
    db = np.stack([v.values for v in vs])
    sims = db @ q / (np.linalg.norm(db, axis=1) * np.linalg.norm(q))
    assert {r["id"] for r in res} == {vs[i].id for i in np.argsort(-sims)[:10]}
    _same_results([res], [jqp.find_similar(jdto(q), 10, "ns", "cosine")])

    for p in (qp, jqp):
        assert p.delete([vs[42].id], "ns") == [vs[42].id]
    res = qp.find_similar(dto(vs[42].values), top_k=3, namespace="ns", metric="l2")
    assert vs[42].id not in [r["id"] for r in res]

    flt = {"i": {"$lt": 20}}
    res = qp.find_similar(dto(q), top_k=50, namespace="ns", filter=flt)
    assert len(res) == 20 and all(r["metadata"]["i"] < 20 for r in res)
    _same_results([res], [jqp.find_similar(jdto(q), 50, "ns", filter=flt)])
    # the query crossed once each way per uncached search
    assert qp.transfer_counts["h2d"] == qp.transfer_counts["d2h"]


def test_distributed_upsert_overwrites_in_place(port_small):
    qp = pmake(1, 8, port_small)
    vid = uuid.uuid4()
    qp.upsert_many([dto([1.0, 0.0, 0.0, 0.0], {"v": 1}, vid)], "ns")
    qp.upsert_many([dto([0.0, 0.0, 0.0, 1.0], {"v": 2}, vid)], "ns")
    assert qp.get_namespace_count("ns") == 1
    res = qp.find_similar(dto([0.0, 0.0, 0.0, 1.0]), top_k=1, namespace="ns", metric="l2")
    assert res[0]["id"] == vid and res[0]["score"] == pytest.approx(0.0, abs=1e-6)


def test_sharded_capacity_growth(rng, port_small, small_config):
    """Growth keeps every row (the JAX case), and the same writes give JAX's
    shard_capacity and every id JAX's slot."""
    qp, jqp = pmake(1, 4, port_small), jmake(1, 4, small_config)
    rows = rng.standard_normal((550, 8)).astype(np.float32)
    vs = qp.upsert_many([dto(r) for r in rows[:50]], "ns")
    jqp.upsert_many([jdto(r, None, v.id) for r, v in zip(rows[:50], vs)], "ns")
    ns, jns = qp.storage.namespace("ns"), jqp.storage.namespace("ns")
    cap0 = ns.capacity
    more = qp.upsert_many([dto(r) for r in rows[50:]], "ns")
    jqp.upsert_many([jdto(r, None, v.id) for r, v in zip(rows[50:], more)], "ns")
    vs += more
    assert ns.capacity > cap0
    assert (ns.shard_capacity, ns.capacity) == (jns.shard_capacity, jns.capacity)
    assert ns._id_to_slot == jns._id_to_slot
    for v in vs[::83]:
        got = qp.storage.read(v.id, "ns")
        np.testing.assert_array_equal(got.values, v.values)
        res = qp.find_similar(dto(v.values), top_k=1, namespace="ns", metric="l2")
        assert res[0]["id"] == v.id


def test_sharded_compaction_preserves_search(rng, port_small):
    qp = pmake(1, 4, port_small)
    vs = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(100)],
                        "ns")
    ns = qp.storage.namespace("ns")
    v0 = ns.version
    qp.delete([v.id for v in vs[:60]], "ns")  # triggers per-shard compaction
    assert ns._tombstones == 0 and ns.version > v0
    res = qp.find_similar(dto(vs[80].values), top_k=1, namespace="ns", metric="l2")
    assert res[0]["id"] == vs[80].id
    assert qp.get_namespace_count("ns") == 40


def test_sharded_compaction_preserves_ivf(rng, port_small):
    qp = pmake(1, 4, port_small)
    vs = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(100)],
                        "ns")
    qp.build_ivf("ns", n_clusters=4)
    qp.delete([v.id for v in vs[:60]], "ns")
    ns = qp.storage.namespace("ns")
    assert ns._tombstones == 0 and ns.ivf is not None
    res = qp.find_similar(dto(vs[80].values), top_k=1, namespace="ns", nprobe=4)
    assert res[0]["id"] == vs[80].id


@pytest.mark.parametrize("sweep", ["float32", "bfloat16"])
def test_sharded_store_maintains_sweep_mirror(rng, oracle, sweep):
    """The per-shard sweep mirror (the rows themselves for f32, bf16 rows with sweep_err
    for bf16) tracks every mutation and growth, and the sharded search through it stays
    oracle-exact; JAX's shard capacity after the same growth."""
    from mlvectordb_tpu_torch.ops.fused_knn_t import sweep_err_norms

    kw = dict(initial_capacity=4096, capacity_multiple=4096, db_tile=64,
              query_buckets=(8, 64), k_buckets=(8, 32), use_pallas=False, sweep_dtype=sweep)
    qp = pmake(2, 4, EngineConfig(**kw))
    jqp = jmake(2, 4, JEngineConfig(**kw))
    rows = rng.standard_normal((200, 16)).astype(np.float32)
    vs = qp.upsert_many([dto(r, {"i": i}) for i, r in enumerate(rows)], "ns")
    ns = qp.storage.namespace("ns")

    def check(st):
        for row in st.shards:
            for cell in row:
                if sweep == "float32":
                    assert cell.mirror is cell.data and cell.sweep_err is None
                else:
                    assert torch.equal(cell.mirror, cell.data.to(torch.bfloat16))
                    assert torch.equal(cell.sweep_err, sweep_err_norms(cell.data))

    check(ns.device_state())
    bulk = rng.standard_normal((18000, 16)).astype(np.float32)
    ids = qp.bulk_load(bulk, "ns")
    jqp.upsert_many([jdto(r, None, v.id) for r, v in zip(rows, vs)], "ns")
    jqp.bulk_load(bulk, "ns", ids=ids)
    assert ns.shard_capacity > 4096 and ns.shard_capacity % 4096 == 0
    assert ns.shard_capacity == jqp.storage.namespace("ns").shard_capacity
    check(ns.device_state())
    qp.delete([vs[3].id], "ns")
    check(ns.device_state())
    live = qp.get_namespace_vectors("ns")
    db = np.stack([v.values for v in live])
    q = rng.standard_normal(16).astype(np.float32)
    _, oidx = oracle(q[None, :], db, 5, "l2")
    got = qp.find_similar(dto(q), top_k=5, namespace="ns", metric="l2")
    assert [r["id"] for r in got] == [live[i].id for i in oidx[0]]


def test_sharded_ivf_matches_single_device_oracle(rng, port_small):
    """The cluster-sharded probe returns what the single-device probe returns on the
    gathered arrays of the same generation, with the lists spread over the shards."""
    from mlvectordb_tpu_torch.store.ivf import _ivf_search

    qp = pmake(2, 4, port_small)
    vs = qp.upsert_many([dto(rng.standard_normal(16).astype(np.float32), {"i": i})
                         for i in range(400)], "ns")
    stats = qp.build_ivf("ns", n_clusters=8, seed=3)
    assert stats["sharded"] is True and stats["shards"] == 4
    ns = qp.storage.namespace("ns")
    g = ns.ivf._gen
    assert [[t.shape[0] for t in row] for row in g.data3] == [[2] * 4] * 2
    assert stats["memory_bytes"] == sum(t.numel() * t.element_size() for a in
                                        (g.data3, g.valid3, g.sqn3) for t in a[0])
    sm = qp.sharding_manager
    B, k = 8, 10
    q = torch.zeros((B, ns.dpad))
    q[:, :16] = torch.from_numpy(rng.standard_normal((B, 16)).astype(np.float32))
    whole = [torch.cat(getattr(g, f)[0]) for f in ("data3", "valid3", "sqn3")]
    for nprobe in (1, 3, 8):
        d_sh, i_sh = sm.sharded_ivf_probe(q, g.centroids, g.cnorms, g.data3, g.valid3, g.sqn3,
                                          k=k, metric="l2", nprobe=nprobe)
        d_1, i_1 = _ivf_search(q, g.centroids, g.cnorms, *whole, k=k, metric="l2",
                               nprobe=nprobe)
        for b in range(B):
            live_sh, live_1 = d_sh[b] < MASKED / 2, d_1[b] < MASKED / 2
            assert set(i_sh[b][live_sh].tolist()) == set(i_1[b][live_1].tolist()), (nprobe, b)
            np.testing.assert_allclose(np.sort(d_sh[b][live_sh].numpy()),
                                       np.sort(d_1[b][live_1].numpy()), rtol=1e-5)
    qv = rng.standard_normal(16).astype(np.float32)
    res = qp.find_similar(dto(qv), top_k=10, namespace="ns", metric="l2", nprobe=8)
    db = np.stack([v.values for v in vs])
    nearest = np.argsort(((db - qv) ** 2).sum(-1))[:10]
    assert {r["id"] for r in res} == {vs[i].id for i in nearest}
    new = qp.upsert_many([dto(rng.standard_normal(16).astype(np.float32)) for _ in range(16)],
                         "ns")
    qp.delete([vs[0].id], "ns")
    assert [[t.shape[0] for t in row] for row in ns.ivf._gen.data3] == [[2] * 4] * 2
    res = qp.find_similar(dto(new[0].values), top_k=1, namespace="ns", nprobe=8)
    assert res[0]["id"] == new[0].id


def test_sharded_ivf_snapshot_roundtrip(tmp_path, rng, port_small):
    from mlvectordb_tpu_torch.engine.persist import load_storage

    qp = pmake(1, 8, port_small)
    qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(300)], "ns")
    qp.build_ivf("ns", n_clusters=16, seed=1)
    q = dto(rng.standard_normal(8).astype(np.float32))
    before = qp.find_similar(q, top_k=5, namespace="ns", nprobe=4)
    qp.save(str(tmp_path / "snap"))
    qp2 = pmake(1, 8, port_small)
    load_storage(str(tmp_path / "snap"), port_small, storage=qp2.storage)
    ns2 = qp2.storage.namespace("ns")
    assert ns2.ivf is not None and ns2.ivf.stats()["sharded"] is True
    assert ns2.ivf._id_to_slot == qp.storage.namespace("ns").ivf._id_to_slot
    after = qp2.find_similar(q, top_k=5, namespace="ns", nprobe=4)
    assert [r["id"] for r in after] == [r["id"] for r in before]
    # a mesh whose shards do not divide C loads the index unsharded
    qp3 = pmake(1, 3, port_small)
    load_storage(str(tmp_path / "snap"), port_small, storage=qp3.storage)
    assert qp3.storage.namespace("ns").ivf.stats()["sharded"] is False
    assert [r["id"] for r in qp3.find_similar(q, 5, "ns", nprobe=4)] == [
        r["id"] for r in before]


# ---------------------------------------------------------------- parity with JAX

@pytest.fixture(scope="module")
def big_rows():
    """65,536 x 128 rows: 8,192 per shard on (1, 8) and 16,384 on (2, 4), so every shard
    runs the port's fused path (two 4,096-row tiles at least) and JAX's."""
    rng = np.random.default_rng(7)
    db = rng.standard_normal((65536, 128), dtype=np.float32)
    q = rng.standard_normal((8, 128), dtype=np.float32)
    sq = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    valid = rng.random(65536) > 0.05   # tombstones in every shard
    return db, q, sq, valid


@pytest.mark.parametrize("filtered", [False, True], ids=["unfiltered", "filtered"])
@pytest.mark.parametrize("mirror", [False, True], ids=["row_major", "bf16_mirror"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("mesh", [(2, 4), (1, 8)], ids=["2x4", "1x8"])
def test_sharded_knn_matches_jax(big_rows, mesh, metric, mirror, filtered):
    """sharded_knn against JAX's on the same arrays: the B5 row-major kernel per shard,
    or the certified sweep B1/B3 + B2 over a bf16 mirror with sweep_err; unfiltered
    (the tombstoned liveness) and filtered (liveness AND a 30% filter's mask, the
    ``valid_override`` JAX's engine passes)."""
    db, q, sq, valid = big_rows
    if filtered:
        valid = valid & (np.random.default_rng(11).random(valid.shape[0]) < 0.3)
    sm = ShardingManager(build_mesh(*mesh, devices=CPU8))
    jsm = JShardingManager(jbuild_mesh(*mesh))
    d, i = _port_sharded(sm, q, db, valid, sq, 5, metric, mirror)
    jd, ji = _jax_sharded(jsm, q, db, valid, sq, 5, metric, mirror)
    np.testing.assert_allclose(d, jd, rtol=RTOL, atol=ATOL)
    assert [set(r) for r in i.tolist()] == [set(r) for r in ji.tolist()]
    assert valid[i].all()


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("mesh", [(2, 4), (1, 8)], ids=["2x4", "1x8"])
def test_sharded_knn_k_above_shard_rows_matches_jax(rng, mesh, metric):
    """k larger than a shard's rows: each shard returns its rows, the merge keeps them
    and the list is padded to k with masked slots, as JAX pads it."""
    db = rng.standard_normal((64, 16), dtype=np.float32)   # 8 rows a shard on (1, 8)
    q = rng.standard_normal((8, 16), dtype=np.float32)
    sq = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    valid = np.ones(64, bool)
    k = 20 if mesh == (2, 4) else 12   # above 16 and 8 rows a shard
    sm = ShardingManager(build_mesh(*mesh, devices=CPU8))
    d, i = _port_sharded(sm, q, db, valid, sq, k, metric)
    jd, ji = _jax_sharded(JShardingManager(jbuild_mesh(*mesh)), q, db, valid, sq, k, metric)
    assert d.shape == jd.shape == (8, k)
    np.testing.assert_allclose(d, jd, rtol=RTOL, atol=ATOL)
    live = d < MASKED / 2
    assert (live == (jd < MASKED / 2)).all()
    assert [set(r[m]) for r, m in zip(i, live)] == [set(r[m]) for r, m in zip(ji, live)]
    assert (i[~live] == 0).all()


@pytest.mark.parametrize("mirror", [False, True], ids=["row_major", "bf16_mirror"])
def test_sharded_knn_live_rows_equal_full_batch(big_rows, mirror):
    """``n_live``: only the live rows are computed and returned (a replica without one is
    skipped), and they equal the full batch's rows (the padded batch sets r1 and the
    gates, per shard, as the JAX package's shard_map gives them)."""
    db, q, sq, valid = big_rows
    sm = ShardingManager(build_mesh(2, 4, devices=CPU8))
    qp = np.zeros((64, 128), np.float32)
    qp[:5] = q[:5]
    for n_live in (5, 40):
        d, i = _port_sharded(sm, qp, db, valid, sq, 16, "l2", mirror, n_live=n_live)
        fd, fi = _port_sharded(sm, qp, db, valid, sq, 16, "l2", mirror)
        assert d.shape == (n_live, 16) and fd.shape == (64, 16)
        np.testing.assert_array_equal(d, fd[:n_live])
        np.testing.assert_array_equal(i, fi[:n_live])


def _same_pair(n=300, dim=16, seed=11, r=2, s=4, port_cfg=None, jax_cfg=None):
    """A port and a JAX distributed processor holding the same rows and ids."""
    rng = np.random.default_rng(seed)
    qp = pmake(r, s, port_cfg or EngineConfig(**SMALL))
    jqp = jmake(r, s, jax_cfg or JEngineConfig(**SMALL))
    rows = rng.standard_normal((n, dim)).astype(np.float32)
    ids = [uuid.UUID(int=int(x)) for x in rng.integers(1, 2**62, n)]
    metas = [{"i": i, "g": "ab"[i % 2]} for i in range(n)]
    qp.upsert_many([dto(v, m, vid) for v, m, vid in zip(rows, metas, ids)], "ns")
    jqp.upsert_many([jdto(v, m, vid) for v, m, vid in zip(rows, metas, ids)], "ns")
    return qp, jqp, rows, ids, rng


def test_same_writes_same_slot_layout():
    """Growth, deletes and compaction: the same slots for every id, the same
    shard_capacity, high-water marks and free lists as the JAX store."""
    qp, jqp, rows, ids, rng = _same_pair(n=60)
    ns, jns = qp.storage.namespace("ns"), jqp.storage.namespace("ns")

    def same():
        assert ns._id_to_slot == jns._id_to_slot
        assert (ns.shard_capacity, ns.capacity) == (jns.shard_capacity, jns.capacity)
        assert ns._shard_free == jns._shard_free and ns._shard_high == jns._shard_high
        assert ns._high_water == jns._high_water

    same()
    more = rng.standard_normal((150, 16)).astype(np.float32)   # grows every shard
    mids = [uuid.UUID(int=10**12 + i) for i in range(150)]
    qp.bulk_load(more, "ns", ids=mids)
    jqp.bulk_load(more, "ns", ids=mids)
    same()
    # below the compaction threshold (tombstones over the slots the high-water marks
    # handed out, which leave out those taken from a regrown range): free lists fill
    gone = ids[:4] + mids[:2]
    assert qp.delete(gone, "ns") == jqp.delete(gone, "ns")
    same()
    assert any(ns._shard_free)
    new = [uuid.UUID(int=10**13 + i) for i in range(7)]
    vals = rng.standard_normal((7, 16)).astype(np.float32)
    qp.upsert_many([dto(v, None, i) for v, i in zip(vals, new)], "ns")
    jqp.upsert_many([jdto(v, None, i) for v, i in zip(vals, new)], "ns")
    same()
    gone = ids[9:80]   # past the threshold: both compact
    qp.delete(gone, "ns")
    jqp.delete(gone, "ns")
    assert ns._tombstones == jns._tombstones == 0
    same()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_snapshot_loads_in_the_other_package(tmp_path, writer):
    """A sharded namespace saved by either package loads into both packages' distributed
    engines with every id in the same slot, and all three answer alike."""
    from mlvectordb_tpu.engine.persist import load_storage as jload
    from mlvectordb_tpu.engine.query_processor import QueryProcessor as JQP
    from mlvectordb_tpu.parallel.store import ShardedNamespaceStore as JStore
    from mlvectordb_tpu.store.storage import StorageEngine as JStorage
    from mlvectordb_tpu_torch.engine.persist import load_storage

    qp, jqp, rows, ids, rng = _same_pair()
    qp.delete(ids[:20], "ns")
    jqp.delete(ids[:20], "ns")
    path = str(tmp_path / "snap")
    (jqp if writer == "jax" else qp).save(path)
    port = pmake(2, 4, EngineConfig(**SMALL))
    load_storage(path, EngineConfig(**SMALL), storage=port.storage)
    jsmall = JEngineConfig(**SMALL)
    jsm = JShardingManager(jbuild_mesh(2, 4))
    jax_ = JQP(jload(path, jsmall, storage=JStorage(
        jsmall, namespace_factory=lambda n: JStore(n, jsm, jsmall))), jsmall)
    pns, jns = port.storage.namespace("ns"), jax_.storage.namespace("ns")
    assert pns._id_to_slot == jns._id_to_slot and pns.shard_capacity == jns.shard_capacity
    assert pns.live_count == qp.get_namespace_count("ns") == 280
    qs = rng.standard_normal((6, 16)).astype(np.float32)
    for metric in ("l2", "cosine"):
        want = qp.find_similar_batch([dto(x) for x in qs], 7, "ns", metric)
        _same_results(port.find_similar_batch([dto(x) for x in qs], 7, "ns", metric), want)
        _same_results(jax_.find_similar_batch([jdto(x) for x in qs], 7, "ns", metric), want)


def test_sharded_from_jax():
    """convert.sharded_from_jax: the JAX store's slots, free lists and marks carried
    across; both answer alike, filters included, and hand out the same next slots."""
    from mlvectordb_tpu_torch.convert import sharded_from_jax
    from mlvectordb_tpu_torch.parallel import ShardedNamespaceStore

    _qp, jqp, rows, ids, rng = _same_pair()
    jqp.delete(ids[:30], "ns")
    jns = jqp.storage.namespace("ns")
    qp = pmake(2, 4, EngineConfig(**SMALL))
    store = ShardedNamespaceStore("ns", qp.sharding_manager, qp.config)
    sharded_from_jax(jns, store)
    qp.storage.attach(store)
    assert store._id_to_slot == jns._id_to_slot and store._shard_free == jns._shard_free
    qs = rng.standard_normal((5, 16)).astype(np.float32)
    for flt in (None, {"g": "a"}):
        _same_results(qp.find_similar_batch([dto(x) for x in qs], 6, "ns", "l2", filter=flt),
                      jqp.find_similar_batch([jdto(x) for x in qs], 6, "ns", "l2", filter=flt))
    new = [uuid.UUID(int=10**14 + i) for i in range(12)]
    vals = rng.standard_normal((12, 16)).astype(np.float32)
    qp.upsert_many([dto(v, None, i) for v, i in zip(vals, new)], "ns")
    jqp.upsert_many([jdto(v, None, i) for v, i in zip(vals, new)], "ns")
    assert [store._id_to_slot[i] for i in new] == [jns._id_to_slot[i] for i in new]


def test_sharded_ivf_matches_jax():
    """A JAX-trained cluster-sharded index carried across (convert.ivf_from_jax): the
    port's sharded probe returns JAX's ids at nprobe 1, 4 and C."""
    from mlvectordb_tpu_torch.convert import ivf_from_jax

    qp, jqp, rows, ids, rng = _same_pair(n=400)
    jstats = jqp.build_ivf("ns", n_clusters=8, seed=3)
    assert jstats["sharded"] and jstats["clusters"] == 8
    ns = qp.storage.namespace("ns")
    ns.ivf = ivf_from_jax(jqp.storage.namespace("ns").ivf, ns)
    assert ns.ivf.stats()["sharded"] is True
    qs = rng.standard_normal((8, 16)).astype(np.float32)
    for nprobe in (1, 4, 8):
        for metric in ("l2", "cosine"):
            _same_results(
                qp.find_similar_batch([dto(x) for x in qs], 10, "ns", metric, nprobe=nprobe),
                jqp.find_similar_batch([jdto(x) for x in qs], 10, "ns", metric, nprobe=nprobe))
    # the port's own build rounds C up to a multiple of the shards, as JAX's does
    assert qp.build_ivf("ns", n_clusters=6)["clusters"] == 8


def test_filtered_sharded_search_twice_keeps_prep_per_shard():
    """ROADMAP trouble 1: a filtered search over the sweep keeps its liveness and prep in
    each shard's own prep dict; run twice (the second from the cached prep), it gives the
    same answers as JAX's filtered sharded search and the numpy oracle."""
    kw = dict(initial_capacity=8192, capacity_multiple=4096, query_buckets=(8, 64),
              k_buckets=(16, 128), sweep_dtype="bfloat16")
    qp, jqp, rows, ids, rng = _same_pair(n=3000, r=1, s=2, port_cfg=EngineConfig(**kw),
                                         jax_cfg=JEngineConfig(**kw))
    ns = qp.storage.namespace("ns")
    st = ns.device_state()
    assert all(cell.mirror is not None for cell in st.shards[0])
    qs = rng.standard_normal((5, 16)).astype(np.float32)
    flt = {"g": "b"}
    first = qp.find_similar_batch([dto(x) for x in qs], 10, "ns", "l2", filter=flt)
    preps = [cell.prep_cache for cell in st.shards[0]]
    assert preps[0] is not preps[1]
    scopes = [[k for k in p if isinstance(k, tuple) and k[0] == "filter"] for p in preps]
    assert all(len(s) == 1 for s in scopes)
    assert preps[0][scopes[0][0]]["valid"].shape == (ns.shard_capacity,)
    qp._result_cache.clear()
    second = qp.find_similar_batch([dto(x) for x in qs], 10, "ns", "l2", filter=flt)
    assert [[r["id"] for r in rs] for rs in first] == [[r["id"] for r in rs] for rs in second]
    _same_results(second, jqp.find_similar_batch([jdto(x) for x in qs], 10, "ns", "l2",
                                                 filter=flt))
    odd = np.arange(len(rows)) % 2 == 1
    d = ((rows[None] - qs[:, None]) ** 2).sum(-1)
    d[:, ~odd] = np.inf
    for rs, order in zip(second, np.argsort(d, axis=1)[:, :10]):
        assert {r["id"] for r in rs} == {ids[j] for j in order}
    unfiltered = qp.find_similar_batch([dto(x) for x in qs], 10, "ns", "l2")
    assert any(r["metadata"]["g"] == "a" for rs in unfiltered for r in rs)


def test_jax_free_space_double_count_collides_the_port_does_not():
    """ROADMAP C12: after a regrow the JAX store counts the regrown range both in the free
    list and behind the high-water mark, so a shard can hand out a slot twice and one id's
    row overwrites another's.  The port counts the real free space and grows instead.
    Every id below hashes to shard 0 of a (1, 2) mesh."""
    ids = iter(uuid.UUID(int=2 * i + 2) for i in range(10**6))
    rng = np.random.default_rng(3)
    qp, jqp = pmake(1, 2, EngineConfig(**SMALL)), jmake(1, 2, JEngineConfig(**SMALL))
    written = {}
    for n in (20, 50, 40, 30):
        batch = [(next(ids), rng.standard_normal(4).astype(np.float32)) for _ in range(n)]
        written.update(batch)
        qp.upsert_many([dto(v, None, i) for i, v in batch], "ns")
        jqp.upsert_many([jdto(v, None, i) for i, v in batch], "ns")
    ns, jns = qp.storage.namespace("ns"), jqp.storage.namespace("ns")
    assert len(set(ns._id_to_slot.values())) == len(written) == 140
    rows = ns.device_state().gathered()[0].numpy()
    for vid, v in written.items():
        np.testing.assert_array_equal(rows[ns._id_to_slot[vid], :4], v)
    # JAX: 12 slots handed out twice; those ids' rows now hold another id's values
    assert len(set(jns._id_to_slot.values())) == 128
    lost = [vid for vid in written if jns._slot_ids[jns._id_to_slot[vid]] != vid]
    assert len(lost) == 12
    assert ns.shard_capacity == 256 and jns.shard_capacity == 128


def test_sharded_explain_and_statistics_match_jax():
    """explain_query and get_statistics report what JAX reports for a sharded namespace:
    the same plan fields, and no certificate tier recorded by its searches (the sharded
    branch records none, query_processor.py:481-487 of the JAX package).  ``fused_active``
    and the backend name differ as for any namespace (ROADMAP C6)."""
    kw = dict(initial_capacity=8192, capacity_multiple=4096, query_buckets=(8, 64),
              k_buckets=(16, 128), sweep_dtype="bfloat16")
    qp, jqp, rows, ids, rng = _same_pair(n=500, r=1, s=2, port_cfg=EngineConfig(**kw),
                                         jax_cfg=JEngineConfig(**kw))
    qs = rng.standard_normal((3, 16)).astype(np.float32)
    for flt in (None, {"g": "a"}):
        _same_results(qp.find_similar_batch([dto(x) for x in qs], 5, "ns", "cosine", flt),
                      jqp.find_similar_batch([jdto(x) for x in qs], 5, "ns", "cosine", flt))
    keys = ("query_type", "namespace", "metric", "higher_is_better", "exact", "certified",
            "exactness_contract", "certificate_tiers", "expected_recall", "live_vectors",
            "scanned_slots", "k_requested", "k_effective", "k_kernel_bucket", "db_tile",
            "filter")
    for flt in (None, {"g": "a"}):
        got = qp.explain_query(dto(qs[0]), 5, "ns", "cosine", flt)
        want = jqp.explain_query(jdto(qs[0]), 5, "ns", "cosine", flt)
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
        assert got["certificate_tiers"] == {} and got["certificate_dispatch"] == "heavy"
    got, want = qp.get_statistics(), jqp.get_statistics()
    assert got["exactness"] == want["exactness"] == {"certify_exact": True,
                                                      "contract": "certified"}
    assert got["queries_by_type"] == want["queries_by_type"] == {"knn": 1, "hybrid": 1}


def test_sharded_escalation_reruns_the_failed_shards():
    """Clustered rows under a bf16 mirror: the shards' tier-1 proofs fail (the heavy
    program without a residual stream, JAX's sharded arguments), each failed shard
    escalates alone with its own counted copies and the lists merge again; the answers
    are the float64 oracle's and JAX's sharded engine's."""
    kw = dict(initial_capacity=16384, capacity_multiple=4096, query_buckets=(8, 64),
              k_buckets=(16, 128), sweep_dtype="bfloat16")
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((64, 32)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 64, 20000)]
         + 0.05 * rng.standard_normal((20000, 32))).astype(np.float32)
    q = (centers[:5] + 0.05 * rng.standard_normal((5, 32))).astype(np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    qp = pmake(1, 2, EngineConfig(**kw))
    jqp = jmake(1, 2, JEngineConfig(**kw))
    qp.bulk_load(x, "c", ids=ids)
    jqp.bulk_load(x, "c", ids=ids)
    res = qp.find_similar_batch([dto(v) for v in q], 10, "c", "l2")
    assert qp.transfer_counts["h2d"] == 1 and qp.transfer_counts["d2h"] > 2
    d = ((x[None].astype(np.float64) - q[:, None]) ** 2).sum(-1)
    for rs, order in zip(res, np.argsort(d, axis=1)[:, :10]):
        assert {r["id"] for r in rs} == {ids[j] for j in order}
    _same_results(res, jqp.find_similar_batch([jdto(v) for v in q], 10, "c", "l2"))


def test_sharded_warmup_runs_every_shard_program_once(port_small):
    """warmup on a sharded namespace runs one ``b{Bb}_k{kb}_{metric}_sharded`` program per
    (bucket, k bucket, metric), as the JAX package's jobs are named, and changes nothing."""
    qp = pmake(2, 2, port_small)
    rng = np.random.default_rng(5)
    qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(50)], "ns")
    ns = qp.storage.namespace("ns")
    v0, st0 = ns.version, ns.device_state()
    n, report = qp.warmup("ns", ks=(10,), batches=(4, 16), metrics=("l2", "cosine"),
                          detail=True)
    assert n == 4 and set(report) == {f"b{b}_k32_{m}_sharded" for b in (4, 16)
                                      for m in ("l2", "cosine")}
    assert ns.version == v0 and ns.device_state() is st0


def _host_mirror_pair(kind, port_cfg, jax_cfg):
    """The port's storage (it takes no ``host_mirror``: it always keeps the written values
    on the host) beside the JAX package's with ``host_mirror=False``, on one device or on
    a (2, 4) mesh."""
    from mlvectordb_tpu.store.storage import StorageEngine as JStorageEngine
    from mlvectordb_tpu_torch import StorageEngine

    if kind == "single":
        with pytest.raises(TypeError):
            StorageEngine(port_cfg, device="cpu", host_mirror=False)
        return (StorageEngine(port_cfg, device="cpu"),
                JStorageEngine(jax_cfg, host_mirror=False))
    with pytest.raises(TypeError):
        pmake(2, 4, port_cfg, host_mirror=False)
    return pmake(2, 4, port_cfg).storage, jmake(2, 4, jax_cfg, host_mirror=False).storage


@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_host_mirror_disabled_reads_from_device(port_small, small_config, rng, kind):
    """tests/test_storage.py:196-209: JAX's ``host_mirror=False`` store reads its rows back
    from the device; the port refuses the option, and its reads return the written values
    (exactly) and JAX's (within JAX's own rtol=1e-6), on one device and on a mesh."""
    from mlvectordb_tpu.store.vector import Vector as JVector
    from mlvectordb_tpu_torch.store.vector import Vector

    storage, jstorage = _host_mirror_pair(kind, port_small, small_config)
    vals = rng.standard_normal((30, 16)).astype(np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(30)]
    storage.write_vectors([Vector(v, {"i": i}, id=vid)
                           for i, (v, vid) in enumerate(zip(vals, ids))], "ns")
    jstorage.write_vectors([JVector(v, {"i": i}, id=vid)
                            for i, (v, vid) in enumerate(zip(vals, ids))], "ns")
    got, want = storage.read(ids[7], "ns"), jstorage.read(ids[7], "ns")
    np.testing.assert_array_equal(got.values, vals[7])
    np.testing.assert_allclose(got.values, want.values, rtol=1e-6)
    assert got.metadata == want.metadata == {"i": 7} and got.values.shape == (16,)
    got2 = storage.read_vectors([ids[1], ids[2]], "ns")
    want2 = jstorage.read_vectors([ids[1], ids[2]], "ns")
    for g, w, v in zip(got2, want2, vals[1:3]):
        np.testing.assert_array_equal(g.values, v)
        np.testing.assert_allclose(g.values, w.values, rtol=1e-6)
    assert ({v.id for v in storage.iterate_vectors("ns")}
            == {v.id for v in jstorage.iterate_vectors("ns")} == set(ids))


@pytest.mark.parametrize("kind", ["single", "sharded"])
def test_host_mirror_disabled_through_engine(port_small, small_config, rng, kind):
    """tests/test_storage.py:212-226: the JAX engine over a ``host_mirror=False`` store
    hydrates from the device rows; the port's engine (host tables in every snapshot)
    gives the same hits, values and metadata, through deletes and the compaction they
    trigger."""
    from mlvectordb_tpu import QueryProcessor as JQueryProcessor
    from mlvectordb_tpu_torch import QueryProcessor

    storage, jstorage = _host_mirror_pair(kind, port_small, small_config)
    qp = QueryProcessor(port_small, device="cpu", storage=storage)
    jqp = JQueryProcessor(jstorage, small_config)
    vals = rng.standard_normal((20, 8)).astype(np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(20)]
    qp.upsert_many([dto(v, {"i": i}, vid) for i, (v, vid) in enumerate(zip(vals, ids))],
                   "ns")
    jqp.upsert_many([jdto(v, {"i": i}, vid) for i, (v, vid) in enumerate(zip(vals, ids))],
                    "ns")
    assert qp.storage.namespace("ns").device_state().host_tables is not None
    res = qp.find_similar(dto(vals[3]), top_k=2, namespace="ns", metric="l2")
    jres = jqp.find_similar(jdto(vals[3]), top_k=2, namespace="ns", metric="l2")
    _same_results([res], [jres])
    assert res[0]["id"] == jres[0]["id"] == ids[3] and res[0]["metadata"] == {"i": 3}
    np.testing.assert_array_equal(res[0]["values"], vals[3])
    np.testing.assert_allclose(res[0]["values"], jres[0]["values"], rtol=1e-6)
    qp.delete(ids[:15], "ns")
    jqp.delete(ids[:15], "ns")
    assert qp.storage.namespace("ns")._tombstones == 0   # compacted
    res = qp.find_similar(dto(vals[17]), top_k=1, namespace="ns", metric="l2")
    jres = jqp.find_similar(jdto(vals[17]), top_k=1, namespace="ns", metric="l2")
    assert res[0]["id"] == jres[0]["id"] == ids[17]
    np.testing.assert_array_equal(res[0]["values"], vals[17])
    np.testing.assert_allclose(res[0]["values"], jres[0]["values"], rtol=1e-6)
