"""The port's REST surface (mlvectordb_tpu_torch/api/rest_api.py) on the CPU: the cases of
tests/test_api.py against the port's QueryProcessor (device="cpu"): route-for-route parity
with the reference's endpoints, the documented-intent /query/* surface, snapshots, the IVF
lifecycle, auth, CORS and margin mode.
"""

import asyncio
import uuid

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from mlvectordb_tpu_torch import EngineConfig, QueryProcessor
from mlvectordb_tpu_torch.api.rest_api import RestAPI

SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128), use_pallas=False)


@pytest.fixture
def small_config():
    """The JAX tests' small config, as the port's EngineConfig."""
    return EngineConfig(**SMALL)


def api_test(fn):
    """Run an async (client, qp) test under a fresh engine + in-process server."""

    def wrapper(small_config):
        async def runner():
            import aiohttp

            qp = QueryProcessor(small_config, device="cpu")
            api = RestAPI(qp, enable_file_logging=False, log_level="WARNING")
            # generous client timeout: on real TPUs a cold compile inside a handler can
            # exceed aiohttp's 5-minute default
            client = TestClient(
                TestServer(api.app), timeout=aiohttp.ClientTimeout(total=1200)
            )
            await client.start_server()
            try:
                await fn(client, qp)
            finally:
                await client.close()

        asyncio.run(runner())

    wrapper.__name__ = fn.__name__
    return wrapper


async def _seed(client, n=20, dim=8, ns="ns", seed=0):
    rng = np.random.default_rng(seed)
    vecs = [
        {"values": rng.standard_normal(dim).astype(float).tolist(), "metadata": {"i": i}}
        for i in range(n)
    ]
    resp = await client.put(f"/vectors/batch?namespace={ns}", json={"vectors": vecs})
    assert resp.status == 200
    body = await resp.json()
    return [uuid.UUID(x) for x in body["ids"]], vecs


@api_test
async def test_health(client, qp):
    resp = await client.get("/health")
    assert resp.status == 200
    body = await resp.json()
    assert body["status"] == "healthy"
    assert "version" in body


@api_test
async def test_insert_returns_201_and_reference_payload(client, qp):
    resp = await client.post(
        "/vectors?namespace=ns", json={"values": [1.0, 2.0], "metadata": {"k": "v"}}
    )
    assert resp.status == 201
    body = await resp.json()
    assert body["status"] == "success"
    assert body["message"] == "Vector inserted"
    assert qp.get_namespace_count("ns") == 1


@api_test
async def test_insert_validation_422(client, qp):
    resp = await client.post("/vectors", json={"metadata": {}})  # missing values
    assert resp.status == 422
    body = await resp.json()
    assert "detail" in body


@api_test
async def test_insert_bad_json_400(client, qp):
    resp = await client.post("/vectors", data=b"not json", headers={"content-type": "application/json"})
    assert resp.status == 400


@api_test
async def test_batch_upsert_and_search_roundtrip(client, qp):
    ids, vecs = await _seed(client, n=15, dim=8)
    resp = await client.post(
        "/search?namespace=ns",
        json={"query": vecs[3]["values"], "top_k": 3, "metric": "euclidean"},
    )
    assert resp.status == 200
    results = await resp.json()
    assert len(results) == 3
    assert uuid.UUID(results[0]["id"]) == ids[3]
    assert results[0]["score"] == pytest.approx(0.0, abs=1e-5)
    assert results[0]["metadata"] == {"i": 3}
    assert [len(r["values"]) for r in results] == [8, 8, 8]


@api_test
async def test_search_topk_bounds_422(client, qp):
    await _seed(client, n=3)
    for bad_k in (0, 1001):
        resp = await client.post(
            "/search?namespace=ns", json={"query": [0.0] * 8, "top_k": bad_k}
        )
        assert resp.status == 422


@api_test
async def test_search_dim_mismatch_500_with_detail(client, qp):
    await _seed(client, n=3, dim=8)
    resp = await client.post("/search?namespace=ns", json={"query": [1.0, 2.0]})
    assert resp.status == 500
    body = await resp.json()
    assert body["detail"].startswith("Search failed:")


@api_test
async def test_true_upsert_via_explicit_id(client, qp):
    vid = str(uuid.uuid4())
    await client.post("/vectors?namespace=ns", json={"values": [1.0, 0.0], "id": vid})
    await client.post(
        "/vectors?namespace=ns", json={"values": [0.0, 1.0], "id": vid, "metadata": {"v": 2}}
    )
    assert qp.get_namespace_count("ns") == 1
    resp = await client.get("/namespaces/vectors?namespace=ns")
    vecs = await resp.json()
    assert len(vecs) == 1
    assert vecs[0]["values"] == [0.0, 1.0]
    assert vecs[0]["metadata"] == {"v": 2}


@api_test
async def test_delete_semantics(client, qp):
    ids, _ = await _seed(client, n=5)
    # empty ids -> 400 (reference rest_api.py:216-221)
    resp = await client.delete("/vectors?namespace=ns", json={"ids": []})
    assert resp.status == 400
    body = await resp.json()
    assert body["detail"] == "No IDs provided"
    # real delete -> success + count message (reference :230-238)
    resp = await client.delete(
        "/vectors?namespace=ns", json={"ids": [str(ids[0]), str(ids[1])]}
    )
    body = await resp.json()
    assert body["status"] == "success" and body["message"] == "2 vectors deleted"
    # additive field: the actually-removed ids (exact router delete accounting)
    assert sorted(body["ids"]) == sorted([str(ids[0]), str(ids[1])])
    # deleting unknown ids -> status error, 0 deleted
    resp = await client.delete("/vectors?namespace=ns", json={"ids": [str(uuid.uuid4())]})
    body = await resp.json()
    assert body["status"] == "error" and body["message"] == "0 vectors deleted"
    assert body["ids"] == []


@api_test
async def test_namespaces_listing_and_delete(client, qp):
    await _seed(client, n=2, ns="a")
    await _seed(client, n=2, ns="b")
    resp = await client.get("/namespaces")
    assert sorted((await resp.json())["namespaces"]) == ["a", "b"]
    resp = await client.delete("/namespaces?namespace=a")
    assert resp.status == 200
    resp = await client.delete("/namespaces?namespace=a")
    assert resp.status == 404
    resp = await client.get("/namespaces")
    assert (await resp.json())["namespaces"] == ["b"]


@api_test
async def test_storage_info_shape(client, qp):
    await _seed(client, n=4)
    resp = await client.get("/storage/info")
    info = await resp.json()
    assert info["total_vectors"] == 4
    assert info["vectors_per_namespace"] == {"ns": 4}
    assert info["namespace_count"] == 1


@api_test
async def test_log_level_endpoint(client, qp):
    resp = await client.post("/log/level?level=banana")
    assert resp.status == 400
    resp = await client.post("/log/level?level=debug")
    assert resp.status == 200
    body = await resp.json()
    assert body["message"] == "Log level set to DEBUG"
    await client.post("/log/level?level=warning")


@api_test
async def test_query_knn_shape_matches_example_client(client, qp):
    ids, vecs = await _seed(client, n=10)
    resp = await client.post(
        "/query/knn", json={"type": "knn", "vector": vecs[0]["values"], "k": 3, "namespace": "ns"}
    )
    assert resp.status == 200
    body = await resp.json()
    # exact keys the reference example client reads (examples/api_client.py:118-130)
    assert body["query_type"] == "knn"
    assert body["total_results"] == 3
    assert isinstance(body["execution_time_ms"], float)
    assert uuid.UUID(body["results"][0]["id"]) == ids[0]
    # missing fields -> 422
    resp = await client.post("/query/knn", json={"vector": [1.0]})
    assert resp.status == 422


@api_test
async def test_query_range_similarity_metadata_hybrid(client, qp):
    ids, vecs = await _seed(client, n=12)
    resp = await client.post(
        "/query/range",
        json={"vector": vecs[0]["values"], "radius": 1e-6, "namespace": "ns", "metric": "l2"},
    )
    body = await resp.json()
    assert body["total_results"] == 1

    resp = await client.post(
        "/query/similarity",
        json={"vector": vecs[1]["values"], "threshold": 0.999, "namespace": "ns"},
    )
    body = await resp.json()
    assert body["total_results"] >= 1
    assert uuid.UUID(body["results"][0]["id"]) == ids[1]

    resp = await client.post(
        "/query/metadata", json={"filter": {"i": {"$lt": 3}}, "namespace": "ns"}
    )
    body = await resp.json()
    assert body["total_results"] == 3

    resp = await client.post(
        "/query/hybrid",
        json={"vector": vecs[0]["values"], "k": 10, "filter": {"i": {"$gte": 6}}, "namespace": "ns"},
    )
    body = await resp.json()
    assert body["total_results"] == 6
    assert all(r["metadata"]["i"] >= 6 for r in body["results"])


@api_test
async def test_query_explain_and_types_and_statistics(client, qp):
    _, vecs = await _seed(client, n=5)
    resp = await client.post(
        "/query/explain", json={"type": "knn", "vector": vecs[0]["values"], "k": 5, "namespace": "ns"}
    )
    body = await resp.json()
    assert body["query_type"] == "knn"
    assert len(body["execution_plan"]["steps"]) >= 3  # example client iterates steps

    resp = await client.get("/query-types")
    body = await resp.json()
    assert "knn" in body["descriptions"]

    await client.post(
        "/query/knn", json={"vector": vecs[0]["values"], "k": 2, "namespace": "ns"}
    )
    resp = await client.get("/statistics")
    stats = await resp.json()
    assert stats["total_queries"] >= 1
    assert stats["knn_queries"] >= 1  # flattened key the example client reads


@api_test
async def test_batch_search_endpoint(client, qp):
    ids, vecs = await _seed(client, n=8)
    resp = await client.post(
        "/search/batch?namespace=ns",
        json={"queries": [vecs[0]["values"], vecs[5]["values"]], "top_k": 1, "metric": "l2"},
    )
    body = await resp.json()
    assert uuid.UUID(body[0][0]["id"]) == ids[0]
    assert uuid.UUID(body[1][0]["id"]) == ids[5]


@api_test
async def test_snapshot_save_load_roundtrip(client, qp):
    import tempfile

    ids, vecs = await _seed(client, n=6)
    with tempfile.TemporaryDirectory() as td:
        resp = await client.post("/snapshot/save", json={"path": td})
        assert resp.status == 200
        resp = await client.delete("/namespaces?namespace=ns")
        assert (await (await client.get("/namespaces")).json())["namespaces"] == []
        resp = await client.post("/snapshot/load", json={"path": td})
        assert resp.status == 200
        resp = await client.post(
            "/search?namespace=ns", json={"query": vecs[2]["values"], "top_k": 1, "metric": "l2"}
        )
        results = await resp.json()
        assert uuid.UUID(results[0]["id"]) == ids[2]


@api_test
async def test_search_missing_namespace_returns_empty_list(client, qp):
    resp = await client.post("/search?namespace=ghost", json={"query": [1.0, 2.0]})
    assert resp.status == 200
    assert await resp.json() == []


@api_test
async def test_ivf_rest_lifecycle(client, qp):
    ids, vecs = await _seed(client, n=64, dim=8)
    resp = await client.post("/ivf/build", json={"namespace": "ns", "n_clusters": 4})
    assert resp.status == 200
    body = await resp.json()
    assert body["clusters"] == 4 and body["live"] == 64

    resp = await client.post(
        "/search?namespace=ns",
        json={"query": vecs[3]["values"], "top_k": 1, "metric": "l2", "nprobe": 4},
    )
    results = await resp.json()
    assert uuid.UUID(results[0]["id"]) == ids[3]

    resp = await client.post(
        "/query/knn",
        json={"vector": vecs[5]["values"], "k": 1, "namespace": "ns", "nprobe": 4},
    )
    body = await resp.json()
    assert uuid.UUID(body["results"][0]["id"]) == ids[5]

    resp = await client.delete("/ivf?namespace=ns")
    assert resp.status == 200
    resp = await client.delete("/ivf?namespace=ns")
    assert resp.status == 404
    resp = await client.post("/ivf/build", json={"namespace": "ghost"})
    assert resp.status == 404


def test_api_key_auth(small_config):
    async def runner():
        qp = QueryProcessor(small_config, device="cpu")
        api = RestAPI(qp, enable_file_logging=False, log_level="WARNING", api_key="s3cret")
        client = TestClient(TestServer(api.app))
        await client.start_server()
        try:
            # health stays open for probes
            assert (await client.get("/health")).status == 200
            # everything else requires the key
            assert (await client.get("/namespaces")).status == 401
            r = await client.post("/vectors", json={"values": [1.0]})
            assert r.status == 401
            # bearer header works
            r = await client.get("/namespaces", headers={"Authorization": "Bearer s3cret"})
            assert r.status == 200
            # X-API-Key works too
            r = await client.get("/namespaces", headers={"X-API-Key": "s3cret"})
            assert r.status == 200
            # wrong key rejected
            r = await client.get("/namespaces", headers={"Authorization": "Bearer nope"})
            assert r.status == 401
        finally:
            await client.close()

    asyncio.run(runner())


def test_cors_headers(small_config):
    """CORS is advertised by the reference README but absent from its code (SURVEY.md
    §2.6 note); here it is real: wildcard default, allowlist mode, preflight, opt-out."""

    async def runner():
        qp = QueryProcessor(small_config, device="cpu")

        # default: wildcard
        api = RestAPI(qp, enable_file_logging=False, log_level="WARNING")
        client = TestClient(TestServer(api.app))
        await client.start_server()
        try:
            r = await client.get("/health", headers={"Origin": "http://app.example"})
            assert r.headers.get("Access-Control-Allow-Origin") == "*"
            # no Origin header -> no CORS headers (not a cross-origin request)
            r = await client.get("/health")
            assert "Access-Control-Allow-Origin" not in r.headers
            # preflight answered without hitting any route (and without auth)
            r = await client.options("/vectors", headers={"Origin": "http://app.example"})
            assert r.status == 204
            assert "POST" in r.headers["Access-Control-Allow-Methods"]
        finally:
            await client.close()

        # allowlist mode
        api = RestAPI(
            qp, enable_file_logging=False, log_level="WARNING",
            cors_origins="http://a.example, http://b.example",
        )
        client = TestClient(TestServer(api.app))
        await client.start_server()
        try:
            r = await client.get("/health", headers={"Origin": "http://a.example"})
            assert r.headers.get("Access-Control-Allow-Origin") == "http://a.example"
            assert r.headers.get("Vary") == "Origin"
            r = await client.get("/health", headers={"Origin": "http://evil.example"})
            assert "Access-Control-Allow-Origin" not in r.headers
        finally:
            await client.close()

        # disabled
        api = RestAPI(qp, enable_file_logging=False, log_level="WARNING", cors_origins=None)
        client = TestClient(TestServer(api.app))
        await client.start_server()
        try:
            r = await client.get("/health", headers={"Origin": "http://a.example"})
            assert "Access-Control-Allow-Origin" not in r.headers
        finally:
            await client.close()

    asyncio.run(runner())


def test_margin_mode_surfaces_in_explain_and_statistics(small_config):
    """A margin-mode server must say so (VERDICT r3 #9): /query/explain reports
    certified=false + the recall-gate contract, /statistics carries the exactness
    block — and the certified default reports the machine-checked contract."""
    import dataclasses

    async def drive(cfg, want_certified):
        import aiohttp

        qp = QueryProcessor(cfg, device="cpu")
        api = RestAPI(qp, enable_file_logging=False, log_level="WARNING")
        client = TestClient(TestServer(api.app), timeout=aiohttp.ClientTimeout(total=1200))
        await client.start_server()
        try:
            await _seed(client, n=5)
            resp = await client.post(
                "/query/explain",
                json={"type": "knn", "vector": [0.0] * 8, "k": 3, "namespace": "ns"},
            )
            plan = (await resp.json())["execution_plan"]
            assert plan["certified"] is want_certified
            if want_certified:
                assert "certified" in plan["exactness_contract"]
                assert plan["expected_recall"] == 1.0
            else:
                # tiny CPU namespace: the fused kernel disengages, so results stay
                # exact — but the server-level contract must still read "margin"
                assert "margin" in plan["exactness_contract"] or plan["exact"]
            resp = await client.get("/statistics")
            stats = await resp.json()
            assert stats["exactness"]["certify_exact"] is want_certified
            assert stats["exactness"]["contract"] == (
                "certified" if want_certified else "margin"
            )
        finally:
            await client.close()

    asyncio.run(drive(small_config, True))
    asyncio.run(drive(dataclasses.replace(small_config, certify_exact=False), False))
