"""The port's gRPC surface (mlvectordb_tpu_torch/api/grpc_server.py) on the CPU: the cases
of tests/test_grpc.py against the port's QueryProcessor (device="cpu")."""

import json
import uuid

import pytest

grpc = pytest.importorskip("grpc")

from mlvectordb_tpu_torch import EngineConfig, QueryProcessor  # noqa: E402
from mlvectordb_tpu_torch.api import vectordb_pb2 as pb  # noqa: E402
from mlvectordb_tpu_torch.api.grpc_server import create_server, make_stub  # noqa: E402

SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128), use_pallas=False)


@pytest.fixture
def small_config():
    """The JAX tests' small config, as the port's EngineConfig."""
    return EngineConfig(**SMALL)


@pytest.fixture
def stub(small_config, rng):
    qp = QueryProcessor(small_config, device="cpu")
    server, port = create_server(qp, port=0)  # ephemeral port
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    yield make_stub(channel), qp, rng
    channel.close()
    server.stop(grace=None)


def test_upsert_search_delete_roundtrip(stub):
    s, qp, rng = stub
    vecs = [
        pb.Vector(values=rng.standard_normal(8).astype(float).tolist(),
                  metadata_json=json.dumps({"i": i}))
        for i in range(20)
    ]
    resp = s.Upsert(pb.UpsertRequest(namespace="ns", vectors=vecs))
    assert len(resp.ids) == 20
    ids = [uuid.UUID(x) for x in resp.ids]
    assert qp.get_namespace_count("ns") == 20

    sr = s.Search(pb.SearchRequest(namespace="ns", query=vecs[3].values, top_k=3, metric="l2"))
    assert len(sr.hits) == 3
    assert uuid.UUID(sr.hits[0].id) == ids[3]
    assert sr.hits[0].score == pytest.approx(0.0, abs=1e-5)
    assert json.loads(sr.hits[0].metadata_json) == {"i": 3}

    dr = s.Delete(pb.DeleteRequest(namespace="ns", ids=[str(ids[0]), str(uuid.uuid4())]))
    assert [uuid.UUID(x) for x in dr.removed_ids] == [ids[0]]

    ns = s.ListNamespaces(pb.NamespacesRequest())
    assert list(ns.namespaces) == ["ns"]

    info = json.loads(s.GetInfo(pb.InfoRequest()).info_json)
    assert info["total_vectors"] == 19


def test_explicit_id_upsert_and_filter(stub):
    s, qp, rng = stub
    vid = str(uuid.uuid4())
    s.Upsert(pb.UpsertRequest(namespace="ns", vectors=[
        pb.Vector(id=vid, values=[1.0, 0.0], metadata_json=json.dumps({"v": 1}))]))
    s.Upsert(pb.UpsertRequest(namespace="ns", vectors=[
        pb.Vector(id=vid, values=[0.0, 1.0], metadata_json=json.dumps({"v": 2}))]))
    assert qp.get_namespace_count("ns") == 1

    s.Upsert(pb.UpsertRequest(namespace="ns", vectors=[
        pb.Vector(values=[1.0, 1.0], metadata_json=json.dumps({"v": 3}))]))
    sr = s.Search(pb.SearchRequest(
        namespace="ns", query=[0.0, 1.0], top_k=5, metric="l2",
        filter_json=json.dumps({"v": 2}),
    ))
    assert len(sr.hits) == 1 and uuid.UUID(sr.hits[0].id) == uuid.UUID(vid)


def test_batch_search(stub):
    s, qp, rng = stub
    vecs = [pb.Vector(values=rng.standard_normal(4).astype(float).tolist())
            for _ in range(10)]
    ids = [uuid.UUID(x) for x in s.Upsert(pb.UpsertRequest(namespace="ns", vectors=vecs)).ids]
    br = s.BatchSearch(pb.BatchSearchRequest(namespace="ns", requests=[
        pb.SearchRequest(query=vecs[0].values, top_k=1, metric="l2"),
        pb.SearchRequest(query=vecs[7].values, top_k=1, metric="l2"),
    ]))
    assert uuid.UUID(br.responses[0].hits[0].id) == ids[0]
    assert uuid.UUID(br.responses[1].hits[0].id) == ids[7]


def test_error_mapping(stub):
    s, qp, rng = stub
    s.Upsert(pb.UpsertRequest(namespace="ns", vectors=[pb.Vector(values=[1.0, 2.0])]))
    # dim mismatch -> INTERNAL (engine ValueError surfaces as internal failure detail)
    with pytest.raises(grpc.RpcError) as exc:
        s.Search(pb.SearchRequest(namespace="ns", query=[1.0, 2.0, 3.0]))
    assert exc.value.code() in (grpc.StatusCode.INTERNAL, grpc.StatusCode.INVALID_ARGUMENT)
    # bad uuid -> INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as exc:
        s.Delete(pb.DeleteRequest(namespace="ns", ids=["not-a-uuid"]))
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    # bad metadata json -> INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as exc:
        s.Upsert(pb.UpsertRequest(namespace="ns", vectors=[
            pb.Vector(values=[1.0, 2.0], metadata_json="{broken")]))
    assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_health(stub):
    s, qp, rng = stub
    assert s.Health(pb.HealthRequest()).status == "healthy"
    deep = s.Health(pb.HealthRequest(deep=True))
    assert deep.status == "healthy"
    report = json.loads(deep.report_json)
    assert report["device"]["ok"] is True
