"""Server CLI of the port: composition root + argparse flags, the counterpart of
``mlvectordb_tpu/api/server.py``.

    python -m mlvectordb_tpu_torch.api.server --device cuda --port 8000

Parity with the reference launcher (reference: src/mlvectordb/api/server.py:15-72 —
--host 127.0.0.1, --port 8000, --reload, --log-level {debug,info,warning,error}; wires the
default stack and runs the HTTP server).  Extended with engine flags (storage dtype,
default metric, snapshot autoload) since the engine is configurable (SURVEY.md §5.6).
``--device`` (cuda by default, or cpu) replaces the JAX package's ``--platform``.
``--mesh-shards N [--mesh-replicas R]`` serves the distributed engine
(``parallel.make_distributed_processor``): its mesh is the visible CUDA devices, repeated
when there are fewer than R*N (so one card serves any mesh), or R*N times the CPU under
``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os

from ..config import EngineConfig, canonical_metric
from ..engine.query_processor import QueryProcessor
from .rest_api import RestAPI


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mlvectordb-torch-server", description="PyTorch + CUDA vector DB REST server"
    )
    p.add_argument("--host", default="127.0.0.1", help="Bind address (default: 127.0.0.1)")
    p.add_argument("--port", type=int, default=8000, help="Port (default: 8000)")
    p.add_argument(
        "--reload",
        action="store_true",
        help="Accepted for CLI parity with the reference; hot reload is not supported",
    )
    p.add_argument(
        "--log-level",
        default="info",
        choices=["debug", "info", "warning", "error"],
        help="Log level (default: info)",
    )
    p.add_argument("--no-file-logging", action="store_true", help="Disable vector_db_api.log")
    p.add_argument(
        "--dtype",
        default="float32",
        choices=["float32", "bfloat16"],
        help="Device storage dtype (bfloat16 halves device memory per vector)",
    )
    p.add_argument(
        "--sweep-dtype",
        default=None,
        choices=["bfloat16", "float32", "int8"],
        help="Maintain a sweep mirror for the certified sweep kernel (bfloat16: a bf16 "
        "mirror with int8 residual codes, or the rows themselves on a bfloat16 store; "
        "int8 = 1 byte/element codes; float32 = the rows themselves on a float32 store, "
        "an f32 copy on a bfloat16 one; all certificate-gated)",
    )
    p.add_argument("--metric", default="l2", help="Default distance metric (l2/ip/cosine)")
    p.add_argument("--db-tile", type=int, default=8192, help="Database-axis kernel tile size")
    p.add_argument("--snapshot", default=None, help="Snapshot directory to load on startup")
    p.add_argument(
        "--wal",
        default=None,
        help="Write-ahead-log directory: mutations are logged before applying and "
        "replayed on startup (crash durability between snapshots)",
    )
    p.add_argument(
        "--wal-fsync",
        action="store_true",
        help="fsync every WAL record (survives host power loss, slower writes)",
    )
    p.add_argument(
        "--wal-checkpoint-mb",
        type=int,
        default=256,
        help="WAL-only mode (no --snapshot): snapshot into <wal>/checkpoint and prune "
        "segments when the log exceeds this many MB, bounding replay time and disk "
        "(0 = never; ignored when --snapshot is set — snapshots already prune)",
    )
    p.add_argument(
        "--snapshot-interval",
        type=float,
        default=0.0,
        help="Seconds between automatic snapshots to --snapshot dir (0 = disabled)",
    )
    p.add_argument("--no-pallas", action="store_true",
                   help="Serve the tiled scan instead of the fused kernel paths")
    p.add_argument(
        "--no-certify",
        action="store_true",
        help="Disable the per-query exactness certificate: return the fast selection "
        "tier unconditionally (exactness then rests on the empirical margin + the "
        "benchmark recall gates — faster on tightly clustered corpora)",
    )
    p.add_argument(
        "--mesh-shards",
        type=int,
        default=0,
        help="Serve a DISTRIBUTED engine: shard every namespace over this many devices "
        "of the mesh (0 = single-device engine).  Combine with --mesh-replicas for "
        "replica groups; POST /mesh/reconcile verifies/repairs replica consistency on "
        "the devices",
    )
    p.add_argument(
        "--mesh-replicas",
        type=int,
        default=1,
        help="Replica groups over the mesh's 'replica' axis (with --mesh-shards)",
    )
    p.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="Device the engine's tensors live on (default: cuda; cpu runs the kernels' "
        "plain versions)",
    )
    p.add_argument(
        "--auto-batch",
        action="store_true",
        help="Coalesce concurrent single-query searches into shared kernel launches",
    )
    p.add_argument(
        "--api-key",
        default=None,
        help="Require this bearer token on every request except /health (default: open)",
    )
    p.add_argument(
        "--cors-origins",
        default="*",
        help='CORS allowlist: "*" (default), comma-separated origins, or "" to disable',
    )
    p.add_argument(
        "--grpc-port",
        type=int,
        default=0,
        help="Also serve gRPC on this port (0 = disabled); see protos/vectordb.proto",
    )
    p.add_argument(
        "--batch-wait-us",
        type=int,
        default=500,
        help="Max microseconds a query waits for batch-mates under --auto-batch",
    )
    return p


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mesh_shards and args.snapshot:
        # the JAX package's refusal, before anything is built
        parser.error("--snapshot is not supported with --mesh-shards yet; "
                     "use --wal for durability")
    if args.reload:
        logging.getLogger("vector_db_api").warning(
            "--reload accepted for parity but ignored (no hot reload)"
        )

    config = EngineConfig(
        dtype=args.dtype,
        sweep_dtype=args.sweep_dtype,
        default_metric=canonical_metric(args.metric),
        db_tile=args.db_tile,
        use_pallas=not args.no_pallas,
        certify_exact=not args.no_certify,
    )
    ckpt_bytes = None
    if args.wal and not args.snapshot and args.wal_checkpoint_mb > 0:
        ckpt_bytes = args.wal_checkpoint_mb << 20
    if args.mesh_shards:
        # distributed serving: every namespace shards over the mesh; durability via WAL
        # replay (mutations re-apply through the engine, which shards them), on top of
        # a WAL-only checkpoint restored INTO the sharded storage
        from ..engine.persist import load_storage, resolve_snapshot_dir
        from ..parallel import make_distributed_processor
        from ..parallel.mesh import mesh_devices

        devices = mesh_devices(args.mesh_replicas * args.mesh_shards, args.device)
        qp = make_distributed_processor(args.mesh_replicas, args.mesh_shards, config,
                                        devices=devices)
        if args.wal:
            ckpt = resolve_snapshot_dir(os.path.join(args.wal, "checkpoint"))
            if ckpt is not None:
                load_storage(ckpt, config, storage=qp.storage)
            qp.replay_wal(args.wal)
            qp.enable_wal(args.wal, fsync=args.wal_fsync, checkpoint_bytes=ckpt_bytes)
    elif args.snapshot or args.wal:
        qp = QueryProcessor.load(
            args.snapshot or "", config, wal_path=args.wal, wal_fsync=args.wal_fsync,
            wal_checkpoint_bytes=ckpt_bytes, device=args.device,
        )
    else:
        qp = QueryProcessor(config, device=args.device)
    if args.snapshot and args.snapshot_interval > 0:
        qp.start_auto_snapshot(args.snapshot, args.snapshot_interval)

    api = RestAPI(
        query_processor=qp,
        title="MLVectorDB-TPU API (PyTorch + CUDA port)",
        enable_file_logging=not args.no_file_logging,
        log_level=args.log_level.upper(),
        batch_queries=args.auto_batch,
        batch_wait_us=args.batch_wait_us,
        api_key=args.api_key,
        cors_origins=args.cors_origins or None,
    )
    if args.mesh_shards:
        logging.getLogger("vector_db_api").info(
            f"mesh {args.mesh_replicas} x {args.mesh_shards} (replica x shard) over "
            f"{[str(d) for d in devices]}")
    if args.grpc_port:
        from .grpc_server import create_server

        grpc_server, bound = create_server(qp, args.grpc_port, args.host)
        grpc_server.start()
        logging.getLogger("vector_db_api").info(
            f"gRPC server listening on {args.host}:{bound}"
        )
    api.run(host=args.host, port=args.port)


if __name__ == "__main__":
    main()
