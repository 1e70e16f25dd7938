"""Service surface of the port: the aiohttp REST API, gRPC, the router and the server CLI
(``python -m mlvectordb_tpu_torch.api.server``).  Imported only by whoever serves:
``import mlvectordb_tpu_torch`` does not import it, since it needs aiohttp and pydantic
(and gRPC needs grpcio and protobuf)."""

from .rest_api import RestAPI

__all__ = ["RestAPI"]
