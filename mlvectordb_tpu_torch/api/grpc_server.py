"""gRPC serving surface (alongside REST) for machine-to-machine traffic: a copy of
``mlvectordb_tpu/api/grpc_server.py`` over the port's QueryProcessor.

Service definition: protos/vectordb.proto (messages generated with plain protoc into
api/vectordb_pb2.py, a byte-identical copy of the JAX package's, so that both register in
one process's protobuf pool without a clash).  The environment ships the grpcio runtime
but not the protoc gRPC plugin, so the method-handler table that grpc_tools would emit is
written explicitly in ``_make_generic_handler`` — it is mechanical (method name -> unary
handler + serializer pair), and doing it by hand keeps the build dependency-free.

Run standalone:  python -m mlvectordb_tpu_torch.api.grpc_server --port 50051 [--device cpu]
or next to REST: python -m mlvectordb_tpu_torch.api.server --grpc-port 50051
"""

from __future__ import annotations

import json
import logging
import uuid as uuid_mod
from concurrent import futures


import numpy as np

from ..engine.query_processor import QueryProcessor
from ..interfaces.vector import VectorDTO
from . import vectordb_pb2 as pb

logger = logging.getLogger("vector_db_grpc")

_SERVICE = "mlvectordb.VectorDB"


class VectorDBServicer:
    """Unary handlers; grpc.StatusCode mapping mirrors the REST error conventions."""

    def __init__(self, query_processor: QueryProcessor):
        self.qp = query_processor

    # ------------------------------------------------------------------ helpers

    @staticmethod
    def _meta(meta_json: str):
        return json.loads(meta_json) if meta_json else {}

    @staticmethod
    def _hit(r) -> pb.SearchHit:
        return pb.SearchHit(
            id=str(r["id"]),
            values=np.asarray(r["values"], np.float32).tolist(),
            metadata_json=json.dumps(r["metadata"]),
            score=float(r["score"]),
        )

    def _search_one(self, req: pb.SearchRequest, namespace: str) -> pb.SearchResponse:
        results = self.qp.find_similar(
            VectorDTO(values=list(req.query), metadata={}),
            top_k=int(req.top_k) or 10,
            namespace=namespace,
            metric=req.metric or None,
            filter=json.loads(req.filter_json) if req.filter_json else None,
            nprobe=int(req.nprobe) or None,
        )
        return pb.SearchResponse(hits=[self._hit(r) for r in results])

    # ------------------------------------------------------------------ rpc methods

    def Upsert(self, request: pb.UpsertRequest, context) -> pb.UpsertResponse:
        try:
            dtos = [
                VectorDTO(
                    values=list(v.values),
                    metadata=self._meta(v.metadata_json),
                    id=uuid_mod.UUID(v.id) if v.id else None,
                )
                for v in request.vectors
            ]
            vs = self.qp.upsert_many(dtos, request.namespace or "default")
            return pb.UpsertResponse(ids=[str(v.id) for v in vs])
        except (ValueError, json.JSONDecodeError) as e:
            _abort_invalid(context, e)
        except Exception as e:  # noqa: BLE001
            _abort_internal(context, "Upsert", e)

    def Search(self, request: pb.SearchRequest, context) -> pb.SearchResponse:
        try:
            return self._search_one(request, request.namespace or "default")
        except (ValueError, json.JSONDecodeError) as e:
            _abort_invalid(context, e)
        except Exception as e:  # noqa: BLE001
            _abort_internal(context, "Search", e)

    def BatchSearch(self, request: pb.BatchSearchRequest, context) -> pb.BatchSearchResponse:
        try:
            ns = request.namespace or "default"
            return pb.BatchSearchResponse(
                responses=[self._search_one(r, ns) for r in request.requests]
            )
        except (ValueError, json.JSONDecodeError) as e:
            _abort_invalid(context, e)
        except Exception as e:  # noqa: BLE001
            _abort_internal(context, "BatchSearch", e)

    def Delete(self, request: pb.DeleteRequest, context) -> pb.DeleteResponse:
        try:
            ids = [uuid_mod.UUID(i) for i in request.ids]
            removed = self.qp.delete(ids, request.namespace or "default")
            return pb.DeleteResponse(removed_ids=[str(i) for i in removed])
        except ValueError as e:
            _abort_invalid(context, e)
        except Exception as e:  # noqa: BLE001
            _abort_internal(context, "Delete", e)

    def ListNamespaces(self, request, context) -> pb.NamespacesResponse:
        return pb.NamespacesResponse(namespaces=self.qp.list_namespaces())

    def GetInfo(self, request, context) -> pb.InfoResponse:
        return pb.InfoResponse(info_json=json.dumps(self.qp.get_storage_info()))

    def Health(self, request: pb.HealthRequest, context) -> pb.HealthResponse:
        if request.deep:
            from ..utils.health import deep_health

            report = deep_health(self.qp)
            return pb.HealthResponse(status=report["status"], report_json=json.dumps(report))
        return pb.HealthResponse(status="healthy", report_json="")


def _abort_invalid(context, e):
    import grpc

    context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))


def _abort_internal(context, op, e):
    import grpc

    logger.error("%s failed: %s", op, e, exc_info=True)
    context.abort(grpc.StatusCode.INTERNAL, f"{op} failed: {e}")


_METHODS = {
    "Upsert": (pb.UpsertRequest, pb.UpsertResponse),
    "Search": (pb.SearchRequest, pb.SearchResponse),
    "BatchSearch": (pb.BatchSearchRequest, pb.BatchSearchResponse),
    "Delete": (pb.DeleteRequest, pb.DeleteResponse),
    "ListNamespaces": (pb.NamespacesRequest, pb.NamespacesResponse),
    "GetInfo": (pb.InfoRequest, pb.InfoResponse),
    "Health": (pb.HealthRequest, pb.HealthResponse),
}


def _make_generic_handler(servicer: VectorDBServicer):
    import grpc

    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req_t.FromString,
            response_serializer=resp_t.SerializeToString,
        )
        for name, (req_t, resp_t) in _METHODS.items()
    }
    return grpc.method_handlers_generic_handler(_SERVICE, handlers)


def create_server(
    query_processor: QueryProcessor,
    port: int = 50051,
    host: str = "127.0.0.1",
    max_workers: int = 16,
):
    """Build (but don't start) a grpc.Server bound to host:port."""
    import grpc

    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((_make_generic_handler(VectorDBServicer(query_processor)),))
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:
        raise OSError(f"could not bind gRPC server to {host}:{port}")
    return server, bound


def make_stub(channel):
    """Client-side callables for the service (the stub grpc_tools would generate)."""
    import grpc  # noqa: F401

    class Stub:
        def __init__(self, ch):
            for name, (req_t, resp_t) in _METHODS.items():
                setattr(
                    self,
                    name,
                    ch.unary_unary(
                        f"/{_SERVICE}/{name}",
                        request_serializer=req_t.SerializeToString,
                        response_deserializer=resp_t.FromString,
                    ),
                )

    return Stub(channel)


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="mlvectordb-torch-grpc")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=50051)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Device the engine's tensors live on (default: cuda)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    qp = QueryProcessor(device=args.device)
    server, bound = create_server(qp, args.port, args.host)
    server.start()
    logger.info("gRPC server listening on %s:%d", args.host, bound)
    server.wait_for_termination()


if __name__ == "__main__":
    main()
