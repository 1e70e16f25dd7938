"""The port's ReplicationManager and the sharded store's reconcile/repair against the JAX
package's, in one process (JAX's 8-device CPU mesh beside the port's ``[cpu] * 8``).

The four replication cases of tests/test_parallel.py have their counterparts here, with
divergence forged the same way: replica 1's copy of some rows differs.  The port's
fingerprint is an exact integer checksum of the stored bits; the one-ulp case pins what
each package's fingerprint sees (ROADMAP C11: JAX's f32 sums round a one-ulp difference
away).  ``POST /mesh/reconcile`` answers 200 on a distributed engine and 409 otherwise.
"""

import asyncio
import uuid

import jax
import numpy as np
import pytest
import torch

from mlvectordb_tpu.parallel import ReplicationManager as JReplicationManager
from mlvectordb_tpu.parallel import build_mesh as jbuild_mesh
from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.parallel import (ReplicationManager, ShardingManager, build_mesh,
                                           make_distributed_processor)

CPU8 = [torch.device("cpu")] * 8
SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128), use_pallas=False)


@pytest.fixture
def mesh24():
    return build_mesh(2, 4, devices=CPU8)


def _placed(mesh, base, corrupted=None):
    """``base`` placed over the mesh, replica 1 then holding ``corrupted`` instead (the
    counterpart of tests/test_parallel.py's ``_forge_divergent``)."""
    sm = ShardingManager(mesh)
    n = base.shape[0]
    data = sm.place(torch.from_numpy(base))
    valid = sm.place(torch.ones(n, dtype=torch.bool))
    if corrupted is not None:
        data[1] = sm.place(torch.from_numpy(corrupted))[1]
    return data, valid


def _jax_forged(base, corrupted):
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jbuild_mesh(2, 4)
    n, d = base.shape
    per = n // 4
    bufs, vb = [], []
    for (r, s), dev in np.ndenumerate(np.array(mesh.devices)):
        src = base if r == 0 else corrupted
        bufs.append(jax.device_put(src[s * per:(s + 1) * per], dev))
        vb.append(jax.device_put(np.ones(per, bool), dev))
    data = jax.make_array_from_single_device_arrays(
        (n, d), NamedSharding(mesh, P("shard", None)), bufs)
    valid = jax.make_array_from_single_device_arrays(
        (n,), NamedSharding(mesh, P("shard")), vb)
    return JReplicationManager(mesh), data, valid


def test_replication_reconcile_consistent(mesh24, rng):
    rm = ReplicationManager(mesh24)
    assert rm.members() == [0, 1]
    data, valid = _placed(mesh24, rng.standard_normal((256, 32), dtype=np.float32))
    report = rm.reconcile(data, valid)
    assert report["consistent"] is True and report["divergent_replicas"] == []
    assert len(report["fingerprints"]) == 2
    assert report["fingerprints"][0] == report["fingerprints"][1]
    # the checksum covers positions: the same rows in another order differ
    swapped = [[t.flip(0) for t in row] for row in data]
    assert rm.reconcile(swapped, valid)["fingerprints"][0] != report["fingerprints"][0]


def test_replication_detects_divergence(mesh24, rng):
    rm = ReplicationManager(mesh24)
    base = rng.standard_normal((256, 32), dtype=np.float32)
    corrupted = base.copy()
    corrupted[0, 0] += 100.0  # replica 1's copy diverges
    report = rm.reconcile(*_placed(mesh24, base, corrupted))
    assert report["consistent"] is False
    assert report["divergent_replicas"] == [1]
    jrm, jdata, jvalid = _jax_forged(base, corrupted)
    assert jrm.reconcile(jdata, jvalid)["divergent_replicas"] == [1]
    # a liveness bit alone is seen too
    data, valid = _placed(mesh24, base)
    valid[1][2] = valid[1][2].clone()
    valid[1][2][5] = False
    assert rm.reconcile(data, valid)["divergent_replicas"] == [1]


def test_one_ulp_divergence_c11(mesh24):
    """ROADMAP C11: one replica's copy of one element differs by one ulp, beside a large
    element of the same row.  The JAX package's f32 row sums round the difference away
    and report consistent; the port's checksum of the bits reports replica 1 (and its
    repair restores the bits)."""
    base = np.zeros((256, 32), np.float32)
    base[:, 0] = 1.0e4
    base[:, 1] = 1.0
    corrupted = base.copy()
    corrupted[37, 1] = np.nextafter(np.float32(1.0), np.float32(2.0))
    jrm, jdata, jvalid = _jax_forged(base, corrupted)
    assert jrm.reconcile(jdata, jvalid)["consistent"] is True       # JAX misses it
    rm = ReplicationManager(mesh24)
    data, valid = _placed(mesh24, base, corrupted)
    report = rm.reconcile(data, valid)
    assert report["consistent"] is False and report["divergent_replicas"] == [1]
    data2, _valid2, rep = rm.repair(data, valid)
    assert rep["repaired"] and rep["source"] == 0 and rep["consistent_after"]
    assert torch.equal(data2[1][0], torch.from_numpy(base[:64]))


def test_replication_repair_restores_consistency(mesh24, rng):
    rm = ReplicationManager(mesh24)
    base = rng.standard_normal((256, 32), dtype=np.float32)
    corrupted = base.copy()
    corrupted[5, :] += 100.0
    data, valid = _placed(mesh24, base, corrupted)
    data2, valid2, report = rm.repair(data, valid)
    assert report["repaired"] is True
    assert report["source"] == 0  # tie between 2 fingerprints -> lowest replica id
    assert report["consistent_after"] is True
    assert rm.reconcile(data2, valid2)["consistent"] is True
    for r in range(2):
        np.testing.assert_array_equal(torch.cat(data2[r]).numpy(), base)
    assert data2[1][0] is not data2[0][0]   # copies: the replicas never alias
    _d, _v, rep2 = rm.repair(data2, valid2)
    assert rep2["repaired"] is False
    # a majority wins: on three replicas the odd one out is repaired from the others
    rm3 = ReplicationManager(build_mesh(3, 2, devices=CPU8))
    sm3 = ShardingManager(rm3.mesh)
    d3 = sm3.place(torch.from_numpy(base))
    v3 = sm3.place(torch.ones(256, dtype=torch.bool))
    d3[0] = sm3.place(torch.from_numpy(corrupted))[0]
    _d, _v, rep3 = rm3.repair(d3, v3)
    assert rep3["source"] == 1 and rep3["divergent_replicas"] == [1, 2]


def test_store_reconcile_and_repair_end_to_end(rng):
    """Corrupt one replica's device rows inside a live sharded store; repair restores
    fingerprint equality and exact search results."""
    qp = make_distributed_processor(2, 4, EngineConfig(**SMALL), devices=CPU8)
    vs = qp.upsert_many([VectorDTO(rng.standard_normal(16).astype(np.float32))
                         for _ in range(64)], "ns")
    ns = qp.storage.namespace("ns")
    rm = qp.replication_manager
    for cell in ns._cells[1]:   # replica 1 silently diverges on a few rows
        cell.data = cell.data.clone()
        cell.data[:4] += 50.0
    ns._publish()
    st = ns.device_state()
    assert rm.reconcile(st.data, st.valid)["divergent_replicas"] == [1]
    report = ns.reconcile_and_repair(rm)
    assert report["repaired"] is True and report["consistent_after"] is True
    st = ns.device_state()
    assert rm.reconcile(st.data, st.valid)["consistent"] is True
    res = qp.find_similar(VectorDTO(vs[17].values), top_k=1, namespace="ns", metric="l2")
    assert res[0]["id"] == vs[17].id and res[0]["score"] == 0.0
    v0 = ns.version
    assert ns.reconcile_and_repair(rm)["repaired"] is False
    assert ns.version == v0


def test_mesh_reconcile_endpoint(rng):
    """``POST /mesh/reconcile``: 200 with the reconcile report on a distributed engine,
    ``repair=1`` repairs a forged divergence, an unknown namespace is 404, and a
    single-device engine answers 409."""
    from aiohttp.test_utils import TestClient, TestServer

    from mlvectordb_tpu_torch.api.rest_api import RestAPI

    async def runner():
        qp = make_distributed_processor(2, 2, EngineConfig(**SMALL), devices=CPU8[:4])
        single = QueryProcessor(EngineConfig(**SMALL), device="cpu")
        clients = [TestClient(TestServer(RestAPI(p, enable_file_logging=False,
                                                 log_level="WARNING").app))
                   for p in (qp, single)]
        for c in clients:
            await c.start_server()
        try:
            qp.upsert_many([VectorDTO(rng.standard_normal(8).astype(np.float32),
                                      id=uuid.UUID(int=i + 1)) for i in range(40)], "m")
            r = await clients[0].post("/mesh/reconcile?namespace=m")
            rep = await r.json()
            assert r.status == 200 and rep["consistent"] is True
            ns = qp.storage.namespace("m")
            cell = ns._cells[1][0]
            cell.data = cell.data.clone()
            cell.data[0, 0] += 1.0
            ns._publish()
            rep = await (await clients[0].post("/mesh/reconcile?namespace=m")).json()
            assert rep["divergent_replicas"] == [1]
            r = await clients[0].post("/mesh/reconcile?namespace=m&repair=1")
            rep = await r.json()
            assert r.status == 200 and rep["repaired"] is True and rep["consistent_after"]
            assert (await clients[0].post("/mesh/reconcile?namespace=nope")).status == 404
            assert (await clients[1].post("/mesh/reconcile?namespace=m")).status == 409
        finally:
            for c in clients:
                await c.close()

    asyncio.run(runner())
