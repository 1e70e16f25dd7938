"""Distribution layer of the port: mesh, sharding, replication, sharded stores — the
counterpart of ``mlvectordb_tpu/parallel``.

Single-controller, as the JAX package is: one process holds a ``[R, S]`` grid of
``torch.device``s (``mesh.Mesh``) and runs every shard's search itself with the port's
kernels, then merges the shards' top-k lists.  On one card every cell of the grid is
``cuda:0``; on four cards the shards sit on ``cuda:0``-``cuda:3`` with the same code.
The cross-node case (several processes and hosts) is the HTTP router (api/router.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..config import DEFAULT_CONFIG, EngineConfig
from ..engine.query_processor import QueryProcessor
from ..store.storage import StorageEngine
from .mesh import REPLICA_AXIS, SHARD_AXIS, Mesh, build_mesh
from .replication import ReplicationManager
from .sharding import ShardingManager, merge_shard_results
from .store import ShardedNamespaceStore, ShardedState

__all__ = [
    "REPLICA_AXIS",
    "SHARD_AXIS",
    "Mesh",
    "build_mesh",
    "ShardingManager",
    "ReplicationManager",
    "ShardedNamespaceStore",
    "ShardedState",
    "merge_shard_results",
    "make_distributed_processor",
]


def make_distributed_processor(
    n_replicas: int = 1,
    n_shards: Optional[int] = None,
    config: EngineConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
    devices: Optional[Sequence[torch.device]] = None,
) -> QueryProcessor:
    """A QueryProcessor whose namespaces are sharded and replicated over the mesh
    (``mesh``, else ``build_mesh(n_replicas, n_shards, devices)``: the visible CUDA
    devices when ``devices`` is None).  Queries arrive and results leave on the mesh's
    first device.  The processor has ``.sharding_manager`` and ``.replication_manager``
    attached; every namespace it creates is a ShardedNamespaceStore."""
    mesh = mesh if mesh is not None else build_mesh(n_replicas, n_shards, devices)
    sm = ShardingManager(mesh)
    rm = ReplicationManager(mesh)
    storage = StorageEngine(
        config, device=mesh.home,
        namespace_factory=lambda name: ShardedNamespaceStore(name, sm, config),
    )
    qp = QueryProcessor(config, device=mesh.home, storage=storage)
    qp.sharding_manager = sm
    qp.replication_manager = rm
    return qp
