"""The port's scatter-gather router (mlvectordb_tpu_torch/api/router.py) on the CPU: the
cases of tests/test_router.py over the port's REST servers (device="cpu"), the case of two
mesh-sharded pods (test_two_mesh_pods_reconcile_over_service_layer) included."""

import asyncio
import uuid

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from mlvectordb_tpu_torch import EngineConfig, QueryProcessor
from mlvectordb_tpu_torch.api.rest_api import RestAPI
from mlvectordb_tpu_torch.api.router import RouterAPI, _merge_results

SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128), use_pallas=False)


@pytest.fixture
def small_config():
    """The JAX tests' small config, as the port's EngineConfig."""
    return EngineConfig(**SMALL)


def test_merge_results_conventions():
    a = [{"id": "1", "score": 0.9}, {"id": "2", "score": 0.5}]
    b = [{"id": "3", "score": 0.7}]
    out = _merge_results([a, b], 2, "cosine")  # higher better
    assert [r["id"] for r in out] == ["1", "3"]
    a = [{"id": "1", "score": 0.1}, {"id": "2", "score": 5.0}]
    b = [{"id": "3", "score": 0.2}]
    out = _merge_results([a, b], 2, "l2")  # lower better
    assert [r["id"] for r in out] == ["1", "3"]


def test_router_end_to_end(small_config, rng):
    async def runner():
        # two real backends
        qps = [QueryProcessor(small_config, device="cpu") for _ in range(2)]
        apis = [RestAPI(qp, enable_file_logging=False, log_level="WARNING") for qp in qps]
        clients = [TestClient(TestServer(a.app)) for a in apis]
        for c in clients:
            await c.start_server()
        backends = [str(c.make_url("")).rstrip("/") for c in clients]

        router = RouterAPI(backends)
        rclient = TestClient(TestServer(router.app))
        await rclient.start_server()
        try:
            # batch upsert through the router: rows split across backends by id hash
            vecs = [
                {"values": rng.standard_normal(8).astype(float).tolist(), "metadata": {"i": i}}
                for i in range(40)
            ]
            resp = await rclient.put("/vectors/batch?namespace=ns", json={"vectors": vecs})
            assert resp.status == 200
            body = await resp.json()
            ids = [uuid.UUID(x) for x in body["ids"]]
            counts = [qp.get_namespace_count("ns") for qp in qps]
            assert sum(counts) == 40
            assert all(c > 0 for c in counts), f"hash routing landed everything on one: {counts}"
            # owner invariant: each id lives on exactly its hash-designated backend
            for i, vid in enumerate(ids):
                owner = vid.int % 2
                assert qps[owner].storage.read(vid, "ns") is not None
                assert qps[1 - owner].storage.read(vid, "ns") is None

            # search broadcasts + merges: global top-1 is the stored vector itself
            resp = await rclient.post(
                "/search?namespace=ns",
                json={"query": vecs[7]["values"], "top_k": 3, "metric": "l2"},
            )
            results = await resp.json()
            assert uuid.UUID(results[0]["id"]) == ids[7]
            assert results[0]["score"] == pytest.approx(0.0, abs=1e-5)
            # merged list is globally sorted
            scores = [r["score"] for r in results]
            assert scores == sorted(scores)

            # router-level single insert routes to the owner
            resp = await rclient.post(
                "/vectors?namespace=ns", json={"values": [9.0] * 8, "metadata": {"x": 1}}
            )
            assert resp.status == 201
            new_id = uuid.UUID((await resp.json())["id"])
            assert qps[new_id.int % 2].storage.read(new_id, "ns") is not None

            # delete fans out to owners only
            resp = await rclient.delete(
                "/vectors?namespace=ns", json={"ids": [str(ids[0]), str(ids[1])]}
            )
            body = await resp.json()
            assert body == {"status": "success", "message": "2 vectors deleted"}

            # aggregation endpoints
            info = await (await rclient.get("/storage/info")).json()
            assert info["total_vectors"] == 39 and info["backend_count"] == 2
            assert info["vectors_per_namespace"]["ns"] == 39
            ns_list = await (await rclient.get("/namespaces")).json()
            assert ns_list["namespaces"] == ["ns"]
            health = await (await rclient.get("/health")).json()
            assert health["status"] == "healthy"
            assert health["backends_up"] == 2 and health["backends_total"] == 2
        finally:
            await rclient.close()
            for c in clients:
                await c.close()

    asyncio.run(runner())


def test_router_degrades_when_backend_down(small_config, rng):
    async def runner():
        qp = QueryProcessor(small_config, device="cpu")
        api = RestAPI(qp, enable_file_logging=False, log_level="WARNING")
        client = TestClient(TestServer(api.app))
        await client.start_server()
        live = str(client.make_url("")).rstrip("/")
        dead = "http://127.0.0.1:1"  # nothing listens here

        router = RouterAPI([live, dead])  # unreachable backends degrade, never crash
        rclient = TestClient(TestServer(router.app))
        await rclient.start_server()
        try:
            health = await rclient.get("/health")
            assert health.status == 503
            body = await health.json()
            assert body["status"] == "degraded" and body["backends_up"] == 1

            # searches still serve from the live backend
            await client.post("/vectors?namespace=ns", json={"values": [1.0, 2.0]})
            resp = await rclient.post("/search?namespace=ns", json={"query": [1.0, 2.0], "metric": "l2"})
            assert resp.status == 200
            assert len(await resp.json()) == 1
        finally:
            await rclient.close()
            await client.close()

    asyncio.run(runner())


def _oracle_top(rows, ids, q, k):
    d = ((rows - q[None, :]) ** 2).sum(-1)
    order = np.argsort(d, kind="stable")[:k]
    return [ids[i] for i in order]


def test_replicated_router_survives_backend_death(small_config, rng):
    """VERDICT r1 next-step #4: with --replicas 2, kill one backend mid-load and
    search results stay SET-EXACT (every id has a surviving owner)."""

    async def runner():
        qps = [QueryProcessor(small_config, device="cpu") for _ in range(3)]
        apis = [RestAPI(qp, enable_file_logging=False, log_level="WARNING") for qp in qps]
        clients = [TestClient(TestServer(a.app)) for a in apis]
        for c in clients:
            await c.start_server()
        backends = [str(c.make_url("")).rstrip("/") for c in clients]

        router = RouterAPI(backends, replicas=2, down_cooldown=30.0)
        rclient = TestClient(TestServer(router.app))
        await rclient.start_server()
        try:
            rows = rng.standard_normal((60, 8)).astype(np.float32)
            vecs = [{"values": r.tolist(), "metadata": {"i": i}} for i, r in enumerate(rows)]
            resp = await rclient.put("/vectors/batch?namespace=ns", json={"vectors": vecs})
            assert resp.status == 200
            body = await resp.json()
            ids = [uuid.UUID(x) for x in body["ids"]]
            assert body["under_replicated"] == 0

            # replication invariant: each id on exactly its TWO chained owners
            for vid in ids:
                p = vid.int % 3
                owners = {p, (p + 1) % 3}
                for b in range(3):
                    present = qps[b].storage.read(vid, "ns") is not None
                    assert present == (b in owners)

            # kill backend 1 mid-load
            await clients[1].close()

            for qi in (3, 17, 42):
                resp = await rclient.post(
                    "/search?namespace=ns",
                    json={"query": rows[qi].tolist(), "top_k": 5, "metric": "l2"},
                )
                assert resp.status == 200
                got = [uuid.UUID(r["id"]) for r in await resp.json()]
                assert got == _oracle_top(rows, ids, rows[qi], 5), "lost results after death"

            # health reports degraded but fault-tolerant
            h = await (await rclient.get("/health")).json()
            assert h["status"] == "degraded" and h["backends_up"] == 2
            assert h["fault_tolerant"] is True

            # writes still succeed on the surviving owner (eviction active)
            resp = await rclient.post("/vectors?namespace=ns", json={"values": [5.0] * 8})
            assert resp.status == 201
            nb = await resp.json()
            assert nb["replicas_acked"] >= 1
        finally:
            await rclient.close()
            for c in clients[:1] + clients[2:]:
                await c.close()

    asyncio.run(runner())


def test_reconcile_detects_and_repairs_divergence(small_config, rng):
    """Anti-entropy: a delete applied to only ONE owner (simulated divergence) is
    detected by fingerprint comparison and repaired by re-replication."""

    async def runner():
        qps = [QueryProcessor(small_config, device="cpu") for _ in range(2)]
        apis = [RestAPI(qp, enable_file_logging=False, log_level="WARNING") for qp in qps]
        clients = [TestClient(TestServer(a.app)) for a in apis]
        for c in clients:
            await c.start_server()
        backends = [str(c.make_url("")).rstrip("/") for c in clients]

        router = RouterAPI(backends, replicas=2)
        rclient = TestClient(TestServer(router.app))
        await rclient.start_server()
        try:
            rows = rng.standard_normal((20, 8)).astype(np.float32)
            vecs = [{"values": r.tolist(), "metadata": {"i": i}} for i, r in enumerate(rows)]
            body = await (await rclient.put("/vectors/batch?namespace=ns", json={"vectors": vecs})).json()
            ids = [uuid.UUID(x) for x in body["ids"]]

            # both owners hold everything (R == N == 2)
            assert qps[0].get_namespace_count("ns") == 20
            assert qps[1].get_namespace_count("ns") == 20

            r = await (await rclient.post("/reconcile?namespace=ns")).json()
            assert r["consistent"] is True and r["divergent_buckets"] == []

            # diverge: delete one vector directly on backend 0, bypassing the router
            qps[0].delete([ids[4]], "ns")
            r = await (await rclient.post("/reconcile?namespace=ns")).json()
            assert r["consistent"] is False
            assert any(d["bucket"] == ids[4].int % 2 for d in r["divergent_buckets"])

            # repair restores the missing copy (merge favors presence)
            r = await (await rclient.post("/reconcile?namespace=ns&repair=1")).json()
            assert r["repaired_vectors"] >= 1
            assert qps[0].storage.read(ids[4], "ns") is not None
            r = await (await rclient.post("/reconcile?namespace=ns")).json()
            assert r["consistent"] is True
        finally:
            await rclient.close()
            for c in clients:
                await c.close()

    asyncio.run(runner())


def test_fingerprint_endpoint_shape(small_config, rng):
    async def runner():
        qp = QueryProcessor(small_config, device="cpu")
        api = RestAPI(qp, enable_file_logging=False, log_level="WARNING")
        client = TestClient(TestServer(api.app))
        await client.start_server()
        try:
            qp.upsert_many(
                [__import__("mlvectordb_tpu_torch").VectorDTO(rng.standard_normal(4).astype(np.float32)) for _ in range(10)],
                "ns",
            )
            body = await (await client.get("/fingerprint?namespace=ns&buckets=4")).json()
            assert body["buckets"] == 4
            assert sum(v["count"] for v in body["fingerprints"].values()) == 10
            # deterministic: same content -> same prints
            again = await (await client.get("/fingerprint?namespace=ns&buckets=4")).json()
            assert again == body
            # bad input
            assert (await client.get("/fingerprint?buckets=x")).status == 400
        finally:
            await client.close()

    asyncio.run(runner())


async def _spin_cluster(small_config, n_backends, replicas=1, api_key=None):
    """(qps, backend_clients, router_client, router) with servers started."""
    qps = [QueryProcessor(small_config, device="cpu") for _ in range(n_backends)]
    apis = [RestAPI(qp, enable_file_logging=False, log_level="WARNING") for qp in qps]
    clients = [TestClient(TestServer(a.app)) for a in apis]
    for c in clients:
        await c.start_server()
    backends = [str(c.make_url("")).rstrip("/") for c in clients]
    router = RouterAPI(backends, api_key=api_key, replicas=replicas)
    rclient = TestClient(TestServer(router.app))
    await rclient.start_server()
    return qps, clients, rclient, router


async def _teardown(clients, rclient):
    await rclient.close()
    for c in clients:
        await c.close()


def test_router_requires_incoming_auth(small_config, rng):
    """--api-key must gate INCOMING requests too, not just be forwarded to backends
    (an open router in front of keyed backends silently removes auth)."""
    async def runner():
        qps, clients, rclient, router = await _spin_cluster(small_config, 1, api_key="sek")
        try:
            resp = await rclient.post(
                "/search?namespace=ns", json={"query": [1.0] * 8, "top_k": 1}
            )
            assert resp.status == 401
            resp = await rclient.get("/storage/info")
            assert resp.status == 401
            # /health stays open for load-balancer probes
            resp = await rclient.get("/health")
            assert resp.status in (200, 503)
            # correct bearer passes through
            resp = await rclient.put(
                "/vectors/batch?namespace=ns",
                json={"vectors": [{"values": [1.0] * 8, "metadata": {}}]},
                headers={"Authorization": "Bearer sek"},
            )
            assert resp.status == 200
        finally:
            await _teardown(clients, rclient)

    asyncio.run(runner())


def test_router_batch_search_fanout_merges_exactly(small_config, rng):
    async def runner():
        qps, clients, rclient, router = await _spin_cluster(small_config, 2)
        try:
            vecs = [
                {"values": rng.standard_normal(8).astype(float).tolist(), "metadata": {}}
                for _ in range(60)
            ]
            body = await (await rclient.put(
                "/vectors/batch?namespace=ns", json={"vectors": vecs}
            )).json()
            ids = body["ids"]
            # batch of 4 queries: each row's global top-1 is the stored vector itself
            queries = [vecs[i]["values"] for i in (3, 17, 29, 41)]
            resp = await rclient.post(
                "/search/batch?namespace=ns",
                json={"queries": queries, "top_k": 3, "metric": "l2"},
            )
            assert resp.status == 200
            rows = await resp.json()
            assert len(rows) == 4
            for row, qi in zip(rows, (3, 17, 29, 41)):
                assert row[0]["id"] == ids[qi]
                assert row[0]["score"] == pytest.approx(0.0, abs=1e-5)
                assert [r["score"] for r in row] == sorted(r["score"] for r in row)

            # /query/knn fan-out returns the documented envelope, globally merged
            resp = await rclient.post(
                "/query/knn",
                json={"vector": vecs[5]["values"], "k": 3, "metric": "l2",
                      "namespace": "ns"},
            )
            assert resp.status == 200
            env = await resp.json()
            assert env["query_type"] == "knn" and env["total_results"] == 3
            assert env["results"][0]["id"] == ids[5]

            # /warmup broadcast reaches every backend
            resp = await rclient.post("/warmup?namespace=ns")
            assert resp.status == 200
            env = await resp.json()
            assert env["backends_warmed"] == 2
        finally:
            await _teardown(clients, rclient)

    asyncio.run(runner())


def test_router_delete_count_exact_under_divergence(small_config, rng):
    """Divergent replicas each holding ids the other lacks: the union of removed ids
    must count BOTH (the old max() heuristic under-counted this edge)."""
    async def runner():
        qps, clients, rclient, router = await _spin_cluster(small_config, 2, replicas=2)
        try:
            from mlvectordb_tpu_torch.interfaces.vector import VectorDTO

            va, vb = uuid.uuid4(), uuid.uuid4()
            # inject divergence directly into the backends, bypassing the router
            qps[0].upsert_many([VectorDTO(np.ones(8, np.float32), {}, id=va)], "ns")
            qps[1].upsert_many([VectorDTO(np.zeros(8, np.float32), {}, id=vb)], "ns")
            resp = await rclient.delete(
                "/vectors?namespace=ns", json={"ids": [str(va), str(vb)]}
            )
            body = await resp.json()
            assert body["message"] == "2 vectors deleted", body
        finally:
            await _teardown(clients, rclient)

    asyncio.run(runner())


def test_router_repair_respects_delete_tombstones(small_config, rng):
    """A delete that reached only some owners must be FINISHED by repair, not
    resurrected by presence-wins merging (ADVICE r2)."""
    async def runner():
        qps, clients, rclient, router = await _spin_cluster(small_config, 2, replicas=2)
        try:
            body = await (await rclient.put(
                "/vectors/batch?namespace=ns",
                json={"vectors": [
                    {"values": rng.standard_normal(8).astype(float).tolist(), "metadata": {}}
                    for _ in range(10)
                ]},
            )).json()
            vid = uuid.UUID(body["ids"][0])
            straggler = router.backends[(vid.int % 2 + 1) % 2]
            # the non-primary owner misses the delete (simulated outage)
            import time as _t

            router._down_until[straggler] = _t.monotonic() + 1000.0
            resp = await rclient.delete("/vectors?namespace=ns", json={"ids": [str(vid)]})
            assert (await resp.json())["status"] == "success"
            router._down_until.pop(straggler)  # backend comes back, still holding vid

            assert sum(qp.storage.read(vid, "ns") is not None for qp in qps) == 1
            rep = await (await rclient.post("/reconcile?namespace=ns&repair=1")).json()
            assert rep["consistent"] is False  # divergence detected
            assert rep["repaired_vectors"] >= 1
            # the delete was finished, not resurrected
            assert all(qp.storage.read(vid, "ns") is None for qp in qps)
            rep2 = await (await rclient.post("/reconcile?namespace=ns")).json()
            assert rep2["consistent"] is True
        finally:
            await _teardown(clients, rclient)

    asyncio.run(runner())


def test_two_mesh_pods_reconcile_over_service_layer(small_config, rng):
    """Cross-pod reconcile: two DISTRIBUTED engines, each its own (replica, shard) mesh of
    devices of its own (two pods that share no mesh), exchange bucketed content
    fingerprints through the service layer (/fingerprint via the router's /reconcile)
    and repair an injected divergence.  In-mesh repair copies tensors between the
    mesh's devices; cross-mesh repair rides the network."""
    import torch

    from mlvectordb_tpu_torch import VectorDTO
    from mlvectordb_tpu_torch.parallel import build_mesh, make_distributed_processor

    async def runner():
        meshes = [build_mesh(1, 2, devices=[torch.device("cpu")] * 2) for _ in range(2)]
        qps = [make_distributed_processor(1, 2, small_config, mesh=m) for m in meshes]
        assert qps[0].sharding_manager.mesh is not qps[1].sharding_manager.mesh
        apis = [RestAPI(qp, enable_file_logging=False, log_level="WARNING") for qp in qps]
        clients = [TestClient(TestServer(a.app)) for a in apis]
        for c in clients:
            await c.start_server()
        backends = [str(c.make_url("")).rstrip("/") for c in clients]
        router = RouterAPI(backends, replicas=2)  # full replication across pods
        rclient = TestClient(TestServer(router.app))
        await rclient.start_server()
        try:
            vecs = [
                {"values": rng.standard_normal(8).astype(float).tolist(),
                 "metadata": {"i": i}}
                for i in range(24)
            ]
            resp = await rclient.put("/vectors/batch?namespace=ns", json={"vectors": vecs})
            assert resp.status == 200
            # replicas=2 over 2 pods => every pod holds every row
            assert [qp.get_namespace_count("ns") for qp in qps] == [24, 24]

            rep = await (await rclient.post("/reconcile?namespace=ns")).json()
            assert rep["consistent"] is True

            # inject divergence: a write lands on pod A only (lost cross-pod delivery)
            lost = await clients[0].post(
                "/vectors?namespace=ns",
                json={"values": [5.0] * 8, "metadata": {"lost": True}},
            )
            lost_id = (await lost.json())["id"]
            rep = await (await rclient.post("/reconcile?namespace=ns")).json()
            assert rep["consistent"] is False and rep["divergent_buckets"]

            # repair re-replicates the richest copy to the lagging pod
            rep = await (await rclient.post("/reconcile?namespace=ns&repair=1")).json()
            assert rep["repaired_vectors"] >= 1
            rep = await (await rclient.post("/reconcile?namespace=ns")).json()
            assert rep["consistent"] is True, rep
            assert qps[1].storage.read(uuid.UUID(lost_id), "ns") is not None
            # the repaired row is searchable THROUGH pod B's own sharded path
            got = qps[1].find_similar(
                VectorDTO(values=np.full(8, 5.0, np.float32)), top_k=1, namespace="ns",
                metric="l2",
            )
            assert str(got[0]["id"]) == lost_id
            # and each pod's replicas agree in-mesh
            for qp in qps:
                st = qp.storage.namespace("ns").device_state()
                assert qp.replication_manager.reconcile(st.data, st.valid)["consistent"]
        finally:
            await rclient.close()
            for c in clients:
                await c.close()

    asyncio.run(runner())
