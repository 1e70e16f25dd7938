"""Scatter-gather router: cross-NODE sharding + replication at the service level; a copy
of ``mlvectordb_tpu/api/router.py`` (it speaks HTTP to the servers and imports only the
config, so it serves either package's servers).

N independent server processes (each a full engine) fronted by a stateless coordinator
that
  * routes writes/deletes by uuid hash to R owner backends (--replicas; the
    ReplicationManager + ShardingManager stubs of the reference's README classDiagram
    made real at service level, SURVEY.md §2.2),
  * broadcasts searches to every LIVE backend and merges the top-k lists by score,
    deduplicating replica copies — with R >= 2 any single backend can die mid-load and
    results stay set-exact because every id has a surviving owner,
  * health-gates backends: a connection failure evicts the backend from fan-outs for a
    cooldown window; /health probes re-admit it,
  * anti-entropy: POST /reconcile compares per-bucket content fingerprints between the
    owners of each bucket and (with ?repair=1) re-replicates the richest copy.

Deliberately stateless: backends own all data; the router can be restarted or
replicated behind a load balancer freely.

Run: python -m mlvectordb_tpu_torch.api.router --port 8000 --replicas 2 \
         --backend http://host-a:8001 --backend http://host-b:8001 ...
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import time
import uuid as uuid_mod
from typing import Any, Dict, List, Optional, Tuple

import aiohttp
from aiohttp import web

from ..config import HIGHER_IS_BETTER, canonical_metric

logger = logging.getLogger("vector_db_router")


def _merge_results(
    result_lists: List[List[Dict[str, Any]]], top_k: int, metric: str
) -> List[Dict[str, Any]]:
    """Fold per-backend result lists into a global top-k (scores are already in the
    user convention: cosine higher-better, l2/ip lower-better).  Replicated ids appear
    in up to R lists; keep the best-scoring copy of each."""
    best: Dict[Any, Dict[str, Any]] = {}
    higher = HIGHER_IS_BETTER[metric]
    for rs in result_lists:
        for r in rs:
            cur = best.get(r["id"])
            if cur is None or (r["score"] > cur["score"] if higher else r["score"] < cur["score"]):
                best[r["id"]] = r
    merged = sorted(best.values(), key=lambda r: r["score"], reverse=higher)
    return merged[:top_k]


class RouterAPI:
    def __init__(
        self,
        backends: List[str],
        api_key: Optional[str] = None,
        replicas: int = 1,
        down_cooldown: float = 3.0,
        tombstone_ttl: float = 3600.0,
    ):
        if not backends:
            raise ValueError("router needs at least one backend URL")
        self.backends = [b.rstrip("/") for b in backends]
        self.replicas = max(1, min(replicas, len(self.backends)))
        self.api_key = api_key
        self.down_cooldown = down_cooldown
        # backend -> monotonic time until which it is considered down (failure eviction)
        self._down_until: Dict[str, float] = {}
        # delete tombstones: (namespace, id) -> wall time of the delete.
        # Repair consults these so a delete that reached only some owners is FINISHED
        # on the stragglers instead of resurrected by presence-wins merging.  Router-
        # local and TTL-bounded: after a router restart or TTL expiry, repair falls
        # back to presence-wins (documented best-effort — the router is stateless by
        # design; durable tombstones belong to the backends' own WALs).
        self.tombstone_ttl = tombstone_ttl
        self._tombstones: Dict[Tuple[str, str], float] = {}
        self._session: Optional[aiohttp.ClientSession] = None
        self.app = self._build_app()

    def _record_tombstones(self, ns: str, ids) -> None:
        now = time.monotonic()
        for i in ids:
            self._tombstones[(ns, str(i))] = now
        if len(self._tombstones) > 1_000_000:  # bound memory under delete floods
            self._gc_tombstones()

    def _gc_tombstones(self) -> None:
        cutoff = time.monotonic() - self.tombstone_ttl
        self._tombstones = {k: t for k, t in self._tombstones.items() if t >= cutoff}

    def _is_tombstoned(self, ns: str, vid: str) -> bool:
        t = self._tombstones.get((ns, vid))
        return t is not None and time.monotonic() - t < self.tombstone_ttl

    # ------------------------------------------------------------------ plumbing

    def _headers(self) -> Dict[str, str]:
        return {"Authorization": f"Bearer {self.api_key}"} if self.api_key else {}

    async def session(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=300), headers=self._headers()
            )
        return self._session

    def _alive(self, backend: str) -> bool:
        return time.monotonic() >= self._down_until.get(backend, 0.0)

    def live_backends(self) -> List[str]:
        up = [b for b in self.backends if self._alive(b)]
        # all evicted (e.g. network blip) -> fail open and try everyone
        return up or list(self.backends)

    def owners_for_id(self, vid: uuid_mod.UUID) -> List[str]:
        """R consecutive backends starting at the id's hash slot (chained
        declustering): every backend is primary for 1/N of ids and replica for the
        next R-1 slots, so losing one backend spreads its load over R-1 peers."""
        n = len(self.backends)
        p = vid.int % n
        return [self.backends[(p + j) % n] for j in range(self.replicas)]

    def backend_for_id(self, vid: uuid_mod.UUID) -> str:
        return self.owners_for_id(vid)[0]

    async def _post_json(self, backend: str, path: str, payload, method="POST"):
        try:
            s = await self.session()
            async with s.request(method, backend + path, json=payload) as resp:
                body = await resp.json()
                return resp.status, body
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError) as e:
            # a dead backend degrades the answer, it must not kill the whole request;
            # evict it from fan-outs until the cooldown passes
            self._down_until[backend] = time.monotonic() + self.down_cooldown
            logger.warning("backend %s unreachable (evicted %.1fs): %s",
                           backend, self.down_cooldown, e)
            return 502, {"detail": f"backend unreachable: {e}"}

    async def _fanout(self, path: str, payload, method="POST", backends=None):
        targets = self.live_backends() if backends is None else backends
        results = await asyncio.gather(
            *[self._post_json(b, path, payload, method) for b in targets]
        )
        return list(zip(targets, results))

    def _auth_middleware(self):
        """When --api-key is set, REQUIRE it on incoming requests too: fronting keyed
        backends with an open router would silently remove auth.
        /health stays open for load-balancer probes (it exposes no data)."""

        @web.middleware
        async def check(request: web.Request, handler):
            if self.api_key and request.path != "/health":
                got = request.headers.get("Authorization", "")
                if got != f"Bearer {self.api_key}":
                    return web.json_response({"detail": "Unauthorized"}, status=401)
            return await handler(request)

        return check

    def _build_app(self) -> web.Application:
        app = web.Application(
            client_max_size=256 * 1024 * 1024, middlewares=[self._auth_middleware()]
        )
        r = app.router
        r.add_post("/vectors", self.insert_vector)
        r.add_put("/vectors/batch", self.upsert_batch)
        r.add_post("/search", self.search)
        r.add_post("/search/batch", self.search_batch)
        r.add_post("/query/knn", self.query_knn)
        r.add_post("/query/hybrid", self.query_hybrid)
        r.add_delete("/vectors", self.delete_vectors)
        r.add_get("/namespaces", self.list_namespaces)
        r.add_get("/storage/info", self.storage_info)
        r.add_get("/health", self.health)
        r.add_post("/warmup", self.warmup)
        r.add_post("/reconcile", self.reconcile)
        app.on_cleanup.append(self._cleanup)
        return app

    async def _cleanup(self, app):
        if self._session and not self._session.closed:
            await self._session.close()

    # ------------------------------------------------------------------ writes

    async def insert_vector(self, request: web.Request) -> web.Response:
        payload = await request.json()
        # mint the id HERE so routing is deterministic and the caller learns it
        vid = uuid_mod.UUID(payload["id"]) if payload.get("id") else uuid_mod.uuid4()
        payload["id"] = str(vid)
        ns = request.query.get("namespace", "default")
        owners = self.owners_for_id(vid)
        targets = [o for o in owners if self._alive(o)] or owners  # fail open
        results = await self._fanout(f"/vectors?namespace={ns}", payload, backends=targets)
        acked = [body for _b, (status, body) in results if status in (200, 201)]
        if not acked:
            return web.json_response(results[0][1][1], status=502)
        body = dict(acked[0])
        body["id"] = str(vid)
        body["replicas_acked"] = len(acked)
        body["replicas_total"] = len(owners)
        return web.json_response(body, status=201)

    async def upsert_batch(self, request: web.Request) -> web.Response:
        payload = await request.json()
        ns = request.query.get("namespace", "default")
        groups: Dict[str, List[dict]] = {}
        ids = []
        acks: Dict[str, int] = {}
        for v in payload.get("vectors", []):
            vid = uuid_mod.UUID(v["id"]) if v.get("id") else uuid_mod.uuid4()
            v["id"] = str(vid)
            ids.append(str(vid))
            acks[str(vid)] = 0
            for owner in self.owners_for_id(vid):
                groups.setdefault(owner, []).append(v)
        targets = {b: vs for b, vs in groups.items() if self._alive(b)} or groups
        results = await asyncio.gather(
            *[
                self._post_json(b, f"/vectors/batch?namespace={ns}", {"vectors": vs}, "PUT")
                for b, vs in targets.items()
            ]
        )
        for (b, vs), (status, _body) in zip(targets.items(), results):
            if status == 200:
                for v in vs:
                    acks[v["id"]] += 1
        unacked = [i for i, n in acks.items() if n == 0]
        if unacked:
            return web.json_response(
                {"detail": f"{len(unacked)} vectors not acked by any owner"}, status=502
            )
        degraded = sum(1 for n in acks.values() if n < self.replicas)
        return web.json_response(
            {
                "status": "success",
                "message": f"{len(ids)} vectors upserted",
                "ids": ids,
                "under_replicated": degraded,
            }
        )

    async def delete_vectors(self, request: web.Request) -> web.Response:
        payload = await request.json()
        ns = request.query.get("namespace", "default")
        ids = payload.get("ids", [])
        if not ids:
            return web.json_response({"detail": "No IDs provided"}, status=400)
        # group ids by their owner tuple so per-request delete counts stay attributable
        groups: Dict[Tuple[str, ...], List[str]] = {}
        for i in ids:
            groups.setdefault(tuple(self.owners_for_id(uuid_mod.UUID(i))), []).append(i)
        removed_union: set = set()
        fallback_counts = 0
        for owners, gids in groups.items():
            live_owners = [o for o in owners if self._alive(o)] or list(owners)
            results = await asyncio.gather(
                *[self._post_json(b, f"/vectors?namespace={ns}", {"ids": gids}, "DELETE")
                  for b in live_owners]
            )
            got_ids = False
            group_max = 0
            for status, body in results:
                if status != 200 or body.get("status") != "success":
                    continue
                if isinstance(body.get("ids"), list):
                    # exact accounting: union of actually-removed ids across replicas
                    # is correct even when divergent replicas each held ids the other
                    # lacked (max() under-counted that edge)
                    removed_union.update(body["ids"])
                    got_ids = True
                else:  # older backend without the ids field
                    group_max = max(group_max, int(body.get("message", "0 ").split()[0]))
            if not got_ids:
                fallback_counts += group_max
        deleted = len(removed_union) + fallback_counts
        self._record_tombstones(ns, removed_union)
        return web.json_response(
            {"status": "success" if deleted else "error", "message": f"{deleted} vectors deleted"}
        )

    # ------------------------------------------------------------------ reads

    async def search(self, request: web.Request) -> web.Response:
        payload = await request.json()
        ns = request.query.get("namespace", "default")
        try:
            metric = canonical_metric(payload.get("metric", "cosine"))
            top_k = int(payload.get("top_k", 10))
        except (ValueError, TypeError) as e:
            return web.json_response({"detail": str(e)}, status=400)
        results = await self._fanout(f"/search?namespace={ns}", payload)
        lists, errors = [], []
        for _b, (status, body) in results:
            (lists if status == 200 else errors).append(body)
        if errors and not lists:
            return web.json_response(errors[0], status=500)
        return web.json_response(_merge_results(lists, top_k, metric))

    async def search_batch(self, request: web.Request) -> web.Response:
        """Batched search fan-out: every live backend answers the whole batch; merge
        per query row (same dedupe/merge as /search, exact under replication)."""
        payload = await request.json()
        ns = request.query.get("namespace", "default")
        try:
            metric = canonical_metric(payload.get("metric", "cosine"))
            top_k = int(payload.get("top_k", 10))
            n_q = len(payload.get("queries") or [])
        except (ValueError, TypeError) as e:
            return web.json_response({"detail": str(e)}, status=400)
        results = await self._fanout(f"/search/batch?namespace={ns}", payload)
        lists, errors = [], []
        for _b, (status, body) in results:
            (lists if status == 200 else errors).append(body)
        if errors and not lists:
            return web.json_response(errors[0], status=500)
        merged = [
            _merge_results([bl[i] for bl in lists if i < len(bl)], top_k, metric)
            for i in range(n_q)
        ]
        return web.json_response(merged)

    async def _query_fanout(self, request: web.Request, path: str) -> web.Response:
        """Fan out a /query/* request; backends return {query_type, results, ...}."""
        payload = await request.json()
        ns = payload.get("namespace") or request.query.get("namespace", "default")
        try:
            metric = canonical_metric(payload.get("metric") or "cosine")
            k = int(payload.get("k") or 10)
        except (ValueError, TypeError) as e:
            return web.json_response({"detail": str(e)}, status=400)
        t0 = time.monotonic()
        results = await self._fanout(f"{path}?namespace={ns}", payload)
        lists, errors = [], []
        kind = path.rsplit("/", 1)[-1]
        for _b, (status, body) in results:
            if status == 200:
                lists.append(body.get("results", []))
            else:
                errors.append(body)
        if errors and not lists:
            return web.json_response(errors[0], status=500)
        merged = _merge_results(lists, k, metric)
        return web.json_response(
            {
                "query_type": kind,
                "results": merged,
                "total_results": len(merged),
                "execution_time_ms": (time.monotonic() - t0) * 1e3,
            }
        )

    async def query_knn(self, request: web.Request) -> web.Response:
        return await self._query_fanout(request, "/query/knn")

    async def query_hybrid(self, request: web.Request) -> web.Response:
        return await self._query_fanout(request, "/query/hybrid")

    async def warmup(self, request: web.Request) -> web.Response:
        """Broadcast /warmup so every backend pre-compiles its serving programs."""
        ns = request.query.get("namespace", "default")
        results = await self._fanout(f"/warmup?namespace={ns}", None)
        per_backend = {
            b: (body if status == 200 else {"detail": body.get("detail", "error")})
            for b, (status, body) in results
        }
        ok = sum(1 for _b, (status, _body) in results if status == 200)
        return web.json_response(
            {"status": "success" if ok else "error", "backends_warmed": ok,
             "backends": per_backend},
            status=200 if ok else 502,
        )

    async def list_namespaces(self, request: web.Request) -> web.Response:
        results = await self._fanout("/namespaces", None, "GET")
        names = set()
        for _b, (status, body) in results:
            if status == 200:
                names.update(body.get("namespaces", []))
        return web.json_response({"namespaces": sorted(names)})

    async def storage_info(self, request: web.Request) -> web.Response:
        results = await self._fanout("/storage/info", None, "GET")
        total = size = 0
        per_ns: Dict[str, int] = {}
        shards = []
        for _b, (status, body) in results:
            if status != 200:
                continue
            total += body.get("total_vectors", 0)
            size += body.get("storage_size_bytes", 0)
            for n, c in (body.get("vectors_per_namespace") or {}).items():
                per_ns[n] = per_ns.get(n, 0) + c
            shards.append(body)
        return web.json_response(
            {
                "storage_type": "routed",
                "total_vectors": total,  # replicas counted once per copy
                "storage_size_bytes": size,
                "namespaces": sorted(per_ns),
                "vectors_per_namespace": per_ns,
                "namespace_count": len(per_ns),
                "backend_count": len(self.backends),
                "replicas": self.replicas,
            }
        )

    async def health(self, request: web.Request) -> web.Response:
        # probe EVERYONE (even evicted backends) and re-admit responders
        results = await self._fanout("/health", None, "GET", backends=self.backends)
        up = 0
        for b, (status, _body) in results:
            if status == 200:
                up += 1
                self._down_until.pop(b, None)
        healthy = up == len(self.backends)
        return web.json_response(
            {
                "status": "healthy" if healthy else "degraded",
                "backends_up": up,
                "backends_total": len(self.backends),
                "replicas": self.replicas,
                # with chained declustering, data survives any (replicas - 1) failures
                "fault_tolerant": (len(self.backends) - up) <= self.replicas - 1,
            },
            status=200 if healthy else 503,
        )

    # ------------------------------------------------------------------ anti-entropy

    async def reconcile(self, request: web.Request) -> web.Response:
        """Compare per-bucket content fingerprints between each bucket's owner set;
        with ?repair=1 re-replicate the richest copy to lagging owners.

        Bucket key == routing key (uuid.int % n_backends), so bucket b lives on exactly
        owners(b) and agreement there is the full replication invariant.  Repair favors
        presence: an id present on any owner is restored everywhere (a delete that
        reached only some owners is undone rather than silently losing the write —
        the same merge bias as the in-mesh ReplicationManager.reconcile).
        """
        ns = request.query.get("namespace", "default")
        repair = request.query.get("repair") in ("1", "true", "yes")
        n = len(self.backends)
        if self.replicas < 2:
            return web.json_response(
                {"namespace": ns, "consistent": True, "divergent_buckets": [],
                 "detail": "replicas=1: nothing to reconcile"}
            )
        results = await self._fanout(f"/fingerprint?namespace={ns}&buckets={n}", None, "GET",
                                     backends=self.backends)
        prints: Dict[str, Dict[str, Any]] = {}
        unreachable = []
        for b, (status, body) in results:
            if status == 200:
                prints[b] = body.get("fingerprints", {})
            else:
                unreachable.append(b)

        divergent: List[Dict[str, Any]] = []
        for bucket in range(n):
            owners = [self.backends[(bucket + j) % n] for j in range(self.replicas)]
            seen = {}
            for o in owners:
                if o in prints:
                    fp = prints[o].get(str(bucket), {"count": 0, "xor": "0"})
                    seen[o] = (fp["count"], fp["xor"])
            if len(set(seen.values())) > 1:
                divergent.append({"bucket": bucket, "owners": {o: list(v) for o, v in seen.items()}})

        repaired = 0
        if repair and divergent:
            repaired = await self._repair(ns, [d["bucket"] for d in divergent])
        return web.json_response(
            {
                "namespace": ns,
                "consistent": not divergent and not unreachable,
                "divergent_buckets": divergent,
                "unreachable": unreachable,
                "repaired_vectors": repaired,
            }
        )

    async def _repair(self, ns: str, buckets: List[int]) -> int:
        """Union-merge each divergent bucket across its owners and re-upsert."""
        n = len(self.backends)
        want = set(buckets)
        # pull full dumps once per distinct owner involved
        involved = sorted({self.backends[(b + j) % n] for b in buckets for j in range(self.replicas)})
        dumps: Dict[str, Dict[str, dict]] = {}
        for o in involved:
            status, body = await self._post_json(o, f"/namespaces/vectors?namespace={ns}", None, "GET")
            if status == 200 and isinstance(body, list):
                dumps[o] = {v["id"]: v for v in body
                            if uuid_mod.UUID(v["id"]).int % n in want}
            else:
                dumps[o] = {}
        # merged truth per bucket: first owner holding the id wins (primary first) —
        # EXCEPT ids the router saw deleted (tombstones): those are finished on any
        # owner still holding them instead of resurrected cluster-wide
        pushes: Dict[str, List[dict]] = {}
        finish_deletes: Dict[str, List[str]] = {}
        for b in buckets:
            owners = [self.backends[(b + j) % n] for j in range(self.replicas)]
            merged: Dict[str, dict] = {}
            for o in owners:
                for vid, v in dumps.get(o, {}).items():
                    if uuid_mod.UUID(vid).int % n != b:
                        continue
                    if self._is_tombstoned(ns, vid):
                        finish_deletes.setdefault(o, []).append(vid)
                        continue
                    merged.setdefault(vid, v)
            for o in owners:
                have = dumps.get(o, {})
                missing = [
                    {"values": v["values"], "metadata": v.get("metadata") or {}, "id": vid}
                    for vid, v in merged.items()
                    if have.get(vid) != v
                ]
                if missing:
                    pushes.setdefault(o, []).extend(missing)
        repaired = 0
        for o, vecs in pushes.items():
            status, _body = await self._post_json(
                o, f"/vectors/batch?namespace={ns}", {"vectors": vecs}, "PUT"
            )
            if status == 200:
                repaired += len(vecs)
        for o, vids in finish_deletes.items():
            status, _body = await self._post_json(
                o, f"/vectors?namespace={ns}", {"ids": vids}, "DELETE"
            )
            if status == 200:
                repaired += len(vids)
        return repaired

    def run(self, host: str = "127.0.0.1", port: int = 8000) -> None:
        web.run_app(self.app, host=host, port=port, print=None)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="mlvectordb-torch-router")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--backend", action="append", required=True, help="Backend base URL (repeatable)")
    p.add_argument("--replicas", type=int, default=1,
                   help="Copies of every vector across distinct backends (default 1 = sharding only)")
    p.add_argument("--api-key", default=None, help="Bearer token forwarded to backends")
    p.add_argument("--down-cooldown", type=float, default=3.0,
                   help="Seconds an unreachable backend is evicted from fan-outs")
    p.add_argument("--tombstone-ttl", type=float, default=3600.0,
                   help="Seconds the router remembers deletes so reconcile?repair=1 "
                   "finishes partial deletes instead of resurrecting them")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    RouterAPI(args.backend, args.api_key, args.replicas, args.down_cooldown,
              args.tombstone_ttl).run(args.host, args.port)


if __name__ == "__main__":
    main()
