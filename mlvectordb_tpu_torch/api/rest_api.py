"""REST API: the reference's HTTP surface, served by aiohttp; a copy of
``mlvectordb_tpu/api/rest_api.py`` over the port's QueryProcessor (the JAX module imports
the JAX engine).  Importing this module needs aiohttp and pydantic, which
``import mlvectordb_tpu_torch`` never imports.

Route-for-route parity with the reference's real endpoints (reference:
src/mlvectordb/api/rest_api.py:96-311 — POST /vectors, PUT /vectors/batch, POST /search,
DELETE /vectors, GET /namespaces, GET /namespaces/vectors, GET /storage/info, GET /health,
POST /log/level) with the same request models, query params, status codes
(201 create / 400 empty delete / 400 bad log level / 500 with {"detail": ...}), the same
success payload strings, and the same logging middleware behavior (request/response lines
with elapsed ms, <1000-byte bodies logged at DEBUG — rest_api.py:347-378).

Additionally implements the documented-intent query API the reference README/example client
advertise but never shipped (SURVEY.md §0.1, examples/api_client.py:26-92):
POST /query/{knn,range,similarity,metadata,hybrid,explain}, GET /statistics,
GET /query-types — so the reference's own example client runs unmodified against this
server.  Validation errors return 422 with a detail list (FastAPI convention).

The stack is aiohttp (async, production HTTP) + pydantic v2 models; blocking engine calls
are pushed to a worker thread via loop.run_in_executor so searches (device compute) don't
stall the event loop — unlike the reference, which calls blocking sync code directly from
async handlers (SURVEY.md §5.2).
"""

from __future__ import annotations

import asyncio
import json
import logging
import sys
import time
import uuid as uuid_mod
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
from aiohttp import web
from pydantic import BaseModel, Field, ValidationError

from .. import __version__
from ..interfaces.vector import VectorDTO
from ..engine.query_processor import QueryProcessor


# --------------------------------------------------------------------------- request models
# (mirror reference rest_api.py:17-46, plus optional id for true upsert)


class VectorCreateRequest(BaseModel):
    values: List[float] = Field(..., description="Vector values")
    metadata: Dict[str, Any] = Field(default_factory=dict)
    id: Optional[uuid_mod.UUID] = Field(None, description="Explicit id => true upsert")


class VectorSearchRequest(BaseModel):
    query: List[float]
    top_k: int = Field(10, ge=1, le=1000)
    metric: str = Field("cosine")
    filter: Optional[Dict[str, Any]] = None
    nprobe: Optional[int] = Field(None, ge=1, description="Use the IVF index, probing this many clusters")


class BatchSearchRequest(BaseModel):
    queries: List[List[float]]
    top_k: int = Field(10, ge=1, le=1000)
    metric: str = Field("cosine")
    filter: Optional[Dict[str, Any]] = None
    nprobe: Optional[int] = Field(None, ge=1)


class VectorDeleteRequest(BaseModel):
    ids: List[uuid_mod.UUID]


class BatchVectorRequest(BaseModel):
    vectors: List[VectorCreateRequest]


class QueryRequest(BaseModel):
    """The documented-intent /query/* body (examples/api_client.py:26-92)."""

    type: Optional[str] = None
    vector: Optional[List[float]] = None
    k: Optional[int] = Field(None, ge=1, le=1000)
    radius: Optional[float] = None
    threshold: Optional[float] = None
    metric: Optional[str] = None
    filter: Optional[Dict[str, Any]] = None
    namespace: Optional[str] = None
    limit: int = Field(1000, ge=1, le=10000)
    nprobe: Optional[int] = Field(None, ge=1)


QUERY_TYPE_DESCRIPTIONS = {
    "knn": "Exact k-nearest-neighbour search (recall 1.0 by construction)",
    "range": "All vectors within a distance radius of the query",
    "similarity": "All vectors with cosine similarity above a threshold",
    "metadata": "Pure metadata-filter query (no vector)",
    "hybrid": "Metadata filter fused into the kNN distance kernel",
}


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, uuid_mod.UUID):
        return str(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def vector_content_hash(vid, values, metadata) -> int:
    """64-bit content hash of one vector record.  MUST be identical across server
    versions participating in one reconcile round (it is the divergence oracle)."""
    import hashlib

    h = hashlib.blake2b(digest_size=8)
    h.update(vid.bytes)
    h.update(np.ascontiguousarray(values, np.float32).tobytes())
    h.update(json.dumps(metadata or {}, sort_keys=True, default=str).encode())
    return int.from_bytes(h.digest(), "big")


def _json(data: Any, status: int = 200) -> web.Response:
    return web.json_response(_jsonable(data), status=status)


def _error(detail: str, status: int) -> web.Response:
    # FastAPI-compatible error envelope {"detail": ...} (reference rest_api.py:116-124)
    return web.json_response({"detail": detail}, status=status)


class RestAPI:
    """Wraps a QueryProcessor in the HTTP surface (reference rest_api.py:49-90)."""

    def __init__(
        self,
        query_processor: QueryProcessor,
        title: str = "Vector DB API",
        enable_file_logging: bool = False,
        log_level: str = "INFO",
        log_file: str = "vector_db_api.log",
        batch_queries: bool = False,
        batch_wait_us: int = 500,
        api_key: Optional[str] = None,
        cors_origins: Optional[str] = "*",
    ):
        self.query_processor = query_processor
        self.title = title
        self.enable_file_logging = enable_file_logging
        self.api_key = api_key  # None = open (reference parity); set = bearer-token auth
        # CORS, which the reference README advertises but never implements (SURVEY.md
        # §2.6 note).  "*" = allow any origin; comma-separated list = allowlist;
        # None/"" = disabled (no CORS headers at all).
        self.cors_origins = cors_origins
        self._setup_logging(log_level, log_file)
        self.logger = logging.getLogger("vector_db_api")
        # engine calls are blocking (device compute + host bookkeeping); a small pool
        # keeps the event loop responsive (writes still serialize on the engine lock)
        self._pool = ThreadPoolExecutor(max_workers=16, thread_name_prefix="vdb")
        # optional micro-batching: concurrent single-query searches coalesce into one
        # shared kernel launch (engine/batcher.py)
        self.micro_batcher = None
        if batch_queries:
            from ..engine.batcher import MicroBatcher

            self.micro_batcher = MicroBatcher(query_processor, max_wait_us=batch_wait_us)
        self.app = self._build_app()

    def _find_similar(self, query, top_k, namespace, metric, filter, nprobe=None):
        if self.micro_batcher is not None and nprobe is None:
            return self.micro_batcher.find_similar(query, top_k, namespace, metric, filter)
        return self.query_processor.find_similar(query, top_k, namespace, metric, filter, nprobe)

    # ------------------------------------------------------------------ plumbing

    def _setup_logging(self, log_level: str, log_file: str) -> None:
        # root-logger takeover with the reference's format (rest_api.py:317-345)
        fmt = logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s", "%Y-%m-%d %H:%M:%S"
        )
        root = logging.getLogger()
        root.setLevel(log_level.upper())
        for h in root.handlers[:]:
            root.removeHandler(h)
        console = logging.StreamHandler(sys.stdout)
        console.setFormatter(fmt)
        root.addHandler(console)
        if self.enable_file_logging:
            fh = logging.FileHandler(log_file, encoding="utf-8")
            fh.setFormatter(fmt)
            root.addHandler(fh)

    async def _run(self, fn, *args, **kwargs):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._pool, lambda: fn(*args, **kwargs))

    def _cors_allow(self, origin: Optional[str]) -> Optional[str]:
        """The Access-Control-Allow-Origin value for this request, or None to omit."""
        if not self.cors_origins or not origin:
            return None
        if self.cors_origins.strip() == "*":
            return "*"
        allowed = {o.strip() for o in self.cors_origins.split(",") if o.strip()}
        return origin if origin in allowed else None

    def _build_app(self) -> web.Application:
        @web.middleware
        async def cors(request: web.Request, handler):
            origin = request.headers.get("Origin")
            if request.method == "OPTIONS":  # preflight: answered here, no route needed
                response = web.Response(status=204)
            else:
                try:
                    response = await handler(request)
                except web.HTTPException as he:
                    response = he
            allow = self._cors_allow(origin)
            if allow is not None:
                response.headers["Access-Control-Allow-Origin"] = allow
                response.headers["Access-Control-Allow-Methods"] = "GET, POST, PUT, DELETE, OPTIONS"
                response.headers["Access-Control-Allow-Headers"] = "Content-Type, Authorization, X-API-Key"
                if allow != "*":
                    response.headers["Vary"] = "Origin"
            if isinstance(response, web.HTTPException):
                raise response
            return response

        @web.middleware
        async def check_auth(request: web.Request, handler):
            # opt-in bearer auth; /health stays open for probes
            if self.api_key is not None and request.path != "/health":
                auth = request.headers.get("Authorization", "")
                supplied = auth[7:] if auth.startswith("Bearer ") else request.headers.get("X-API-Key", "")
                if supplied != self.api_key:
                    return _error("Unauthorized", 401)
            return await handler(request)

        @web.middleware
        async def log_requests(request: web.Request, handler):
            # timing middleware (reference rest_api.py:347-378)
            start = time.time()
            self.logger.info(f"-> Incoming request: {request.method} {request.path}")
            if request.method in ("POST", "PUT") and self.logger.isEnabledFor(logging.DEBUG):
                try:
                    body = await request.read()
                    if len(body) < 1000:
                        self.logger.debug(f"Request body: {body.decode()}")
                except Exception as e:  # pragma: no cover
                    self.logger.warning(f"Could not read request body: {e}")
            try:
                response = await handler(request)
            except web.HTTPException as he:
                response = he
            elapsed = (time.time() - start) * 1000
            self.logger.info(
                f"<- Response: {request.method} {request.path} - "
                f"Status: {response.status} - Time: {elapsed:.2f}ms"
            )
            if isinstance(response, web.HTTPException):
                raise response
            return response

        app = web.Application(
            middlewares=[log_requests, cors, check_auth],
            client_max_size=256 * 1024 * 1024,
        )
        r = app.router
        r.add_post("/vectors", self.insert_vector)
        r.add_put("/vectors/batch", self.upsert_vectors)
        r.add_post("/search", self.search_similar)
        r.add_post("/search/batch", self.search_batch)
        r.add_delete("/vectors", self.delete_vectors)
        r.add_get("/namespaces", self.list_namespaces)
        r.add_delete("/namespaces", self.delete_namespace)
        r.add_get("/namespaces/vectors", self.get_namespace_vectors)
        r.add_get("/storage/info", self.get_storage_info)
        r.add_get("/health", self.health)
        r.add_post("/log/level", self.set_log_level)
        # documented-intent query API (SURVEY.md §0.1)
        r.add_post("/query/knn", self.query_knn)
        r.add_post("/query/range", self.query_range)
        r.add_post("/query/similarity", self.query_similarity)
        r.add_post("/query/metadata", self.query_metadata)
        r.add_post("/query/hybrid", self.query_hybrid)
        r.add_post("/query/explain", self.query_explain)
        r.add_get("/statistics", self.statistics)
        r.add_get("/query-types", self.query_types)
        # snapshots (persistence the reference README promises but lacks)
        r.add_post("/snapshot/save", self.snapshot_save)
        r.add_post("/snapshot/load", self.snapshot_load)
        # approximate index lifecycle
        r.add_post("/ivf/build", self.ivf_build)
        r.add_delete("/ivf", self.ivf_drop)
        r.add_post("/warmup", self.warmup)
        # offload tier: park cold namespaces in host RAM, page in on first touch
        r.add_post("/namespaces/offload", self.offload_namespace)
        r.add_post("/namespaces/restore", self.restore_namespace)
        # bucketed content fingerprints: the router's cross-node reconcile primitive
        r.add_get("/fingerprint", self.fingerprint)
        # in-mesh replica verification/repair (distributed engines: --mesh-shards)
        r.add_post("/mesh/reconcile", self.mesh_reconcile)
        # observability: engine spans + on-demand device profiling (SURVEY.md §5.1)
        r.add_get("/trace", self.get_trace)
        r.add_get("/metrics", self.get_metrics)
        r.add_post("/profile/start", self.profile_start)
        r.add_post("/profile/stop", self.profile_stop)
        return app

    async def _parse(self, request: web.Request, model):
        try:
            payload = await request.json()
        except json.JSONDecodeError:
            raise web.HTTPBadRequest(
                text=json.dumps({"detail": "Invalid JSON body"}),
                content_type="application/json",
            )
        try:
            return model.model_validate(payload)
        except ValidationError as e:
            # FastAPI-style 422 envelope
            raise web.HTTPUnprocessableEntity(
                text=json.dumps({"detail": json.loads(e.json())}),
                content_type="application/json",
            )

    # ------------------------------------------------------------------ core routes
    # (parity surface — see module docstring)

    async def insert_vector(self, request: web.Request) -> web.Response:
        ns = request.query.get("namespace", "default")
        body = await self._parse(request, VectorCreateRequest)
        self.logger.info(
            f"Insert request - namespace: {ns}, dim: {len(body.values)}, "
            f"metadata keys: {list(body.metadata.keys())}"
        )
        try:
            dto = VectorDTO(values=body.values, metadata=body.metadata, id=body.id)
            v = await self._run(self.query_processor.insert, dto, ns)
            return _json({"status": "success", "message": "Vector inserted", "id": str(v.id)}, 201)
        except Exception as e:
            self.logger.error(f"Insert failed - namespace: {ns}: {e}", exc_info=True)
            return _error(f"Insert failed: {e}", 500)

    async def upsert_vectors(self, request: web.Request) -> web.Response:
        ns = request.query.get("namespace", "default")
        body = await self._parse(request, BatchVectorRequest)
        self.logger.info(f"Batch upsert - namespace: {ns}, count: {len(body.vectors)}")
        try:
            dtos = [VectorDTO(values=v.values, metadata=v.metadata, id=v.id) for v in body.vectors]
            vs = await self._run(self.query_processor.upsert_many, dtos, ns)
            return _json(
                {
                    "status": "success",
                    "message": f"{len(vs)} vectors upserted",
                    "ids": [str(v.id) for v in vs],
                }
            )
        except Exception as e:
            self.logger.error(f"Batch upsert failed - namespace: {ns}: {e}", exc_info=True)
            return _error(f"Batch upsert failed: {e}", 500)

    async def search_similar(self, request: web.Request) -> web.Response:
        ns = request.query.get("namespace", "default")
        body = await self._parse(request, VectorSearchRequest)
        self.logger.info(
            f"Search - namespace: {ns}, top_k: {body.top_k}, metric: {body.metric}"
        )
        try:
            results = await self._run(
                self._find_similar,
                VectorDTO(values=body.query, metadata={}),
                body.top_k,
                ns,
                body.metric,
                body.filter,
                body.nprobe,
            )
            return _json(results)
        except Exception as e:
            self.logger.error(f"Search failed - namespace: {ns}: {e}", exc_info=True)
            return _error(f"Search failed: {e}", 500)

    async def search_batch(self, request: web.Request) -> web.Response:
        ns = request.query.get("namespace", "default")
        body = await self._parse(request, BatchSearchRequest)
        try:
            results = await self._run(
                self.query_processor.find_similar_batch,
                [VectorDTO(values=q, metadata={}) for q in body.queries],
                body.top_k,
                ns,
                body.metric,
                body.filter,
                body.nprobe,
            )
            return _json(results)
        except Exception as e:
            self.logger.error(f"Batch search failed - namespace: {ns}: {e}", exc_info=True)
            return _error(f"Batch search failed: {e}", 500)

    async def delete_vectors(self, request: web.Request) -> web.Response:
        ns = request.query.get("namespace", "default")
        body = await self._parse(request, VectorDeleteRequest)
        if not body.ids:
            return _error("No IDs provided", 400)
        try:
            removed = await self._run(self.query_processor.delete, body.ids, ns)
            return _json(
                {
                    "status": "success" if removed else "error",
                    "message": f"{len(removed)} vectors deleted",
                    # additive field (reference payload keeps status/message): the
                    # router unions these across replicas for an exact delete count
                    # even when divergent replicas each hold ids the other lacks
                    "ids": [str(i) for i in removed],
                }
            )
        except Exception as e:
            self.logger.error(f"Delete failed - namespace: {ns}: {e}", exc_info=True)
            return _error(f"Delete failed: {e}", 500)

    async def list_namespaces(self, request: web.Request) -> web.Response:
        try:
            return _json({"namespaces": self.query_processor.list_namespaces()})
        except Exception as e:
            return _error(f"Failed to list namespaces: {e}", 500)

    async def delete_namespace(self, request: web.Request) -> web.Response:
        ns = request.query.get("namespace", "default")
        try:
            delete_ns = getattr(
                self.query_processor, "delete_namespace",
                self.query_processor.storage.delete_namespace,
            )
            ok = await self._run(delete_ns, ns)
            if not ok:
                return _error(f"Namespace not found: {ns}", 404)
            return _json({"status": "success", "message": f"Namespace {ns} deleted"})
        except Exception as e:
            return _error(f"Failed to delete namespace: {e}", 500)

    async def get_namespace_vectors(self, request: web.Request) -> web.Response:
        ns = request.query.get("namespace", "default")
        try:
            vectors = await self._run(self.query_processor.get_namespace_vectors, ns)
            return _json(
                [
                    {"id": v.id, "values": v.values, "metadata": v.metadata}
                    for v in vectors
                ]
            )
        except Exception as e:
            return _error(f"Failed to get vectors: {e}", 500)

    async def get_storage_info(self, request: web.Request) -> web.Response:
        try:
            return _json(self.query_processor.get_storage_info())
        except Exception as e:
            return _error(f"Failed to get storage info: {e}", 500)

    async def offload_namespace(self, request: web.Request) -> web.Response:
        ns = request.query.get("namespace", "default")
        try:
            ok = await self._run(self.query_processor.offload_namespace, ns)
            if not ok:
                return _error(f"Namespace '{ns}' not found or already offloaded", 404)
            return _json({"status": "success", "message": f"Namespace '{ns}' offloaded to host RAM"})
        except Exception as e:
            return _error(f"Offload failed: {e}", 500)

    async def restore_namespace(self, request: web.Request) -> web.Response:
        ns = request.query.get("namespace", "default")
        try:
            ok = await self._run(self.query_processor.restore_namespace, ns)
            return _json({
                "status": "success",
                "message": f"Namespace '{ns}' {'restored to device' if ok else 'was already resident'}",
            })
        except Exception as e:
            return _error(f"Restore failed: {e}", 500)

    def _fingerprint_sync(self, namespace: str, buckets: int) -> dict:
        out = {}
        for vid, vec in (
            (v.id, v) for v in self.query_processor.get_namespace_vectors(namespace)
        ):
            b = vid.int % buckets
            h = vector_content_hash(vid, vec.values, vec.metadata)
            cnt, acc = out.get(b, (0, 0))
            out[b] = (cnt + 1, acc ^ h)
        return {
            "namespace": namespace,
            "buckets": buckets,
            "fingerprints": {str(b): {"count": c, "xor": format(x, "x")} for b, (c, x) in out.items()},
        }

    async def fingerprint(self, request: web.Request) -> web.Response:
        """Bucketed order-independent content checksums (bucket = uuid.int % buckets).

        The router's reconcile compares bucket b across the backends that replicate
        bucket b; any count/xor mismatch localizes divergence to one (namespace,
        bucket) pair.  XOR of per-vector hashes is insertion-order independent and
        incremental-friendly.  Walks the host tables — O(live) per call, intended for
        periodic anti-entropy, not the hot path.
        """
        ns = request.query.get("namespace", "default")
        try:
            buckets = max(1, int(request.query.get("buckets", "64")))
        except ValueError:
            return _error("buckets must be an integer", 400)
        try:
            return _json(await self._run(self._fingerprint_sync, ns, buckets))
        except Exception as e:
            return _error(f"Fingerprint failed: {e}", 500)

    async def mesh_reconcile(self, request: web.Request) -> web.Response:
        """In-mesh replica verification/repair for distributed engines.

        Requires a processor built by make_distributed_processor (server CLI
        --mesh-shards); 409 otherwise.  Verifies per-replica content fingerprints on
        device; with ?repair=1, divergence re-broadcasts the majority replica's rows
        over the replica axis and republishes atomically
        (ShardedNamespaceStore.reconcile_and_repair)."""
        rm = getattr(self.query_processor, "replication_manager", None)
        if rm is None:
            return _error("engine is not distributed (start with --mesh-shards)", 409)
        ns_name = request.query.get("namespace", "default")
        repair = request.query.get("repair") in ("1", "true", "yes")

        def run():
            ns = self.query_processor.storage.namespace(ns_name)
            if ns is None:
                raise KeyError(ns_name)
            if repair:
                return ns.reconcile_and_repair(rm)
            state = ns.device_state()
            if state is None:
                return {"consistent": True, "repaired": False}
            return rm.reconcile(state.data, state.valid)

        try:
            return _json(await self._run(run))
        except KeyError:
            return _error(f"Namespace '{ns_name}' not found", 404)
        except Exception as e:
            return _error(f"Mesh reconcile failed: {e}", 500)

    async def health(self, request: web.Request) -> web.Response:
        # plain: constant-time liveness (parity with reference rest_api.py:292-296);
        # ?deep=1: real failure detection — device probe + store invariants
        if request.query.get("deep") in ("1", "true", "yes"):
            from ..utils.health import deep_health

            report = await self._run(deep_health, self.query_processor)
            return _json(report, 200 if report["status"] == "healthy" else 503)
        return _json({"status": "healthy", "version": __version__})

    async def get_trace(self, request: web.Request) -> web.Response:
        from ..utils.tracing import RECORDER

        limit = int(request.query.get("limit", "100"))
        return _json({"summary": RECORDER.summary(), "recent": RECORDER.recent(limit)})

    async def get_metrics(self, request: web.Request) -> web.Response:
        from ..utils.metrics import render_metrics
        from ..utils.tracing import RECORDER

        text = await self._run(render_metrics, self.query_processor, RECORDER)
        return web.Response(text=text, content_type="text/plain", charset="utf-8")

    async def profile_start(self, request: web.Request) -> web.Response:
        from ..utils.tracing import PROFILER

        try:
            payload = await request.json()
            log_dir = payload["log_dir"]
        except Exception:
            return _error("profile start requires JSON body with 'log_dir'", 422)
        try:
            await self._run(PROFILER.start, log_dir)
            return _json({"status": "success", "message": f"tracing to {log_dir}"})
        except RuntimeError as e:
            return _error(str(e), 409)

    async def profile_stop(self, request: web.Request) -> web.Response:
        from ..utils.tracing import PROFILER

        try:
            log_dir = await self._run(PROFILER.stop)
            return _json({"status": "success", "message": f"trace written to {log_dir}"})
        except RuntimeError as e:
            return _error(str(e), 409)

    async def set_log_level(self, request: web.Request) -> web.Response:
        level = request.query.get("level", "")
        valid = ["DEBUG", "INFO", "WARNING", "ERROR"]
        if level.upper() not in valid:
            return _error(f"Invalid level. Must be one of: {valid}", 400)
        logging.getLogger().setLevel(level.upper())
        self.logger.info(f"Log level changed to: {level.upper()}")
        return _json({"status": "success", "message": f"Log level set to {level.upper()}"})

    # ------------------------------------------------------------------ /query/* routes
    # (documented-intent surface: the reference's example client runs against these)

    def _query_common(self, body: QueryRequest, request: web.Request) -> str:
        return body.namespace or request.query.get("namespace", "default")

    async def _timed_query(self, kind: str, fn, *args, **kwargs) -> web.Response:
        t0 = time.perf_counter()
        try:
            results = await self._run(fn, *args, **kwargs)
        except Exception as e:
            self.logger.error(f"{kind} query failed: {e}", exc_info=True)
            return _error(f"{kind} query failed: {e}", 500)
        ms = (time.perf_counter() - t0) * 1000
        return _json(
            {
                "query_type": kind,
                "results": results,
                "total_results": len(results),
                "execution_time_ms": ms,
            }
        )

    async def query_knn(self, request: web.Request) -> web.Response:
        body = await self._parse(request, QueryRequest)
        if body.vector is None or body.k is None:
            return _error("knn query requires 'vector' and 'k'", 422)
        ns = self._query_common(body, request)
        return await self._timed_query(
            "knn",
            self._find_similar,
            VectorDTO(values=body.vector, metadata={}),
            body.k,
            ns,
            body.metric,
            body.filter,
            body.nprobe,
        )

    async def query_range(self, request: web.Request) -> web.Response:
        body = await self._parse(request, QueryRequest)
        if body.vector is None or body.radius is None:
            return _error("range query requires 'vector' and 'radius'", 422)
        ns = self._query_common(body, request)
        return await self._timed_query(
            "range",
            self.query_processor.range_search,
            VectorDTO(values=body.vector, metadata={}),
            body.radius,
            ns,
            body.metric,
            body.filter,
            body.limit,
        )

    async def query_similarity(self, request: web.Request) -> web.Response:
        body = await self._parse(request, QueryRequest)
        if body.vector is None or body.threshold is None:
            return _error("similarity query requires 'vector' and 'threshold'", 422)
        ns = self._query_common(body, request)
        return await self._timed_query(
            "similarity",
            self.query_processor.similarity_search,
            VectorDTO(values=body.vector, metadata={}),
            body.threshold,
            ns,
            body.filter,
            body.limit,
        )

    async def query_metadata(self, request: web.Request) -> web.Response:
        body = await self._parse(request, QueryRequest)
        if body.filter is None:
            return _error("metadata query requires 'filter'", 422)
        ns = self._query_common(body, request)
        return await self._timed_query(
            "metadata", self.query_processor.query_by_metadata, body.filter, ns, body.limit
        )

    async def query_hybrid(self, request: web.Request) -> web.Response:
        body = await self._parse(request, QueryRequest)
        if body.vector is None or body.filter is None:
            return _error("hybrid query requires 'vector' and 'filter'", 422)
        ns = self._query_common(body, request)
        return await self._timed_query(
            "hybrid",
            self._find_similar,
            VectorDTO(values=body.vector, metadata={}),
            body.k or 10,
            ns,
            body.metric,
            body.filter,
        )

    async def query_explain(self, request: web.Request) -> web.Response:
        body = await self._parse(request, QueryRequest)
        if body.vector is None:
            return _error("explain requires 'vector'", 422)
        ns = self._query_common(body, request)
        try:
            plan = await self._run(
                self.query_processor.explain_query,
                VectorDTO(values=body.vector, metadata={}),
                body.k or 10,
                ns,
                body.metric,
                body.filter,
            )
        except Exception as e:
            return _error(f"explain failed: {e}", 500)
        steps = [
            f"resolve namespace '{ns}' ({plan['live_vectors']} live vectors, "
            f"{plan['scanned_slots']} slots)",
            f"compute {plan['metric']} distances on the device in {plan['db_tile']}-row tiles",
        ]
        if body.filter:
            steps.insert(1, "apply metadata filter bitmask inside the kernel")
        steps.append(
            f"streaming top-{plan['k_kernel_bucket']} accumulator, emit best "
            f"{plan['k_effective']}"
        )
        steps.append("hydrate ids/metadata from host tables")
        return _json(
            {
                "query_type": plan["query_type"],
                "execution_plan": {"steps": steps, **plan},
            }
        )

    async def statistics(self, request: web.Request) -> web.Response:
        stats = self.query_processor.get_statistics()
        if self.micro_batcher is not None:
            stats["micro_batcher"] = self.micro_batcher.stats()
        by_type = stats["queries_by_type"]
        # flatten to the example client's expected keys (examples/api_client.py:168-171)
        flat = {f"{k}_queries": v for k, v in by_type.items()}
        return _json({**stats, **flat})

    async def query_types(self, request: web.Request) -> web.Response:
        return _json(
            {
                "query_types": list(QUERY_TYPE_DESCRIPTIONS),
                "descriptions": QUERY_TYPE_DESCRIPTIONS,
            }
        )

    # ------------------------------------------------------------------ ivf

    async def ivf_build(self, request: web.Request) -> web.Response:
        try:
            payload = await request.json()
        except Exception:
            payload = {}
        ns = payload.get("namespace", request.query.get("namespace", "default"))
        try:
            stats = await self._run(
                self.query_processor.build_ivf,
                ns,
                payload.get("n_clusters"),
                payload.get("cluster_capacity"),
                payload.get("n_iters", 10),
                payload.get("seed", 0),
                payload.get("spill", 1),
            )
            return _json({"status": "success", "message": f"IVF built for {ns}", **stats})
        except ValueError as e:
            return _error(str(e), 404)
        except Exception as e:
            self.logger.error(f"IVF build failed: {e}", exc_info=True)
            return _error(f"IVF build failed: {e}", 500)

    async def ivf_drop(self, request: web.Request) -> web.Response:
        ns = request.query.get("namespace", "default")
        dropped = await self._run(self.query_processor.drop_ivf, ns)
        if not dropped:
            return _error(f"no IVF index on namespace {ns}", 404)
        return _json({"status": "success", "message": f"IVF dropped for {ns}"})

    async def warmup(self, request: web.Request) -> web.Response:
        try:
            payload = await request.json()
        except Exception:
            payload = {}
        ns = payload.get("namespace", request.query.get("namespace", "default"))
        try:
            ran, report = await self._run(
                self.query_processor.warmup,
                ns,
                tuple(payload.get("ks", (10, 100))),
                tuple(payload.get("batches", (1, 8, 128))),
                tuple(payload.get("metrics", ("l2", "cosine"))),
                True,  # detail: per-program seconds
                # None = auto (masked variant only when tombstones exist); pass
                # true when serving metadata-FILTERED queries (they always take
                # the masked kernel)
                payload.get("include_masked"),
            )
            return _json({
                "status": "success",
                "programs_warmed": ran,
                "seconds_total": round(sum(report.values()), 3),
                "programs": report,
            })
        except Exception as e:
            return _error(f"warmup failed: {e}", 500)

    # ------------------------------------------------------------------ snapshots

    async def snapshot_save(self, request: web.Request) -> web.Response:
        try:
            payload = await request.json()
            path = payload["path"]
        except Exception:
            return _error("snapshot save requires JSON body with 'path'", 422)
        try:
            await self._run(self.query_processor.save, path)
            return _json({"status": "success", "message": f"Snapshot saved to {path}"})
        except Exception as e:
            return _error(f"Snapshot save failed: {e}", 500)

    async def snapshot_load(self, request: web.Request) -> web.Response:
        try:
            payload = await request.json()
            path = payload["path"]
        except Exception:
            return _error("snapshot load requires JSON body with 'path'", 422)
        try:
            from ..engine.persist import load_storage

            storage = await self._run(load_storage, path, self.query_processor.config,
                                      device=self.query_processor.device)
            self.query_processor.storage = storage
            return _json({"status": "success", "message": f"Snapshot loaded from {path}"})
        except Exception as e:
            return _error(f"Snapshot load failed: {e}", 500)

    # ------------------------------------------------------------------ entrypoints

    def get_app(self) -> web.Application:
        return self.app

    def run(self, host: str = "127.0.0.1", port: int = 8000) -> None:
        self.logger.info(f"Vector DB API starting on http://{host}:{port}")
        web.run_app(self.app, host=host, port=port, print=None)
