"""Device mesh of the distributed engine: the counterpart of
``mlvectordb_tpu/parallel/mesh.py``.

The mesh has two named axes, as the JAX package's ``jax.sharding.Mesh`` does:
  * "replica": query-data-parallel.  Each replica group serves a disjoint slice of the
    query batch against a full copy of the database: replicas buy QPS and fault
    tolerance.
  * "shard": database-parallel.  Each shard holds a contiguous slot range of every
    namespace; a search runs exact kNN per shard and merges the top-k lists.

Single-controller, as the JAX package is: one process holds a ``[R, S]`` grid of
``torch.device``s and issues every shard's work itself (no process group, no NCCL).  A
device may repeat in the grid: on one card every cell is ``cuda:0``, on four cards the
same code runs with ``cuda:0``-``cuda:3``, and the tests run ``[cpu] * 8`` beside the JAX
package's 8 simulated CPU devices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

REPLICA_AXIS = "replica"
SHARD_AXIS = "shard"


class Mesh:
    """A ``[R, S]`` grid of devices with the JAX mesh's ``shape`` dict."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.devices: List[List[torch.device]] = [[torch.device(d) for d in row]
                                                  for row in grid]
        if not self.devices or not self.devices[0] or any(
                len(row) != len(self.devices[0]) for row in self.devices):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.shape = {REPLICA_AXIS: len(self.devices), SHARD_AXIS: len(self.devices[0])}

    @property
    def home(self) -> torch.device:
        """The first device: queries arrive and merged results leave here."""
        return self.devices[0][0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[[str(d) for d in row] for row in self.devices]})"


def visible_devices() -> List[torch.device]:
    """The visible CUDA devices; raises when there is none (the mesh never carries on
    on the CPU unless the caller passes CPU devices)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is visible: pass the mesh's devices explicitly "
                           "(e.g. [torch.device('cpu')] * 8)")
    return [torch.device("cuda", i) for i in range(n)]


def mesh_devices(n: int, device="cuda") -> List[torch.device]:
    """n devices for a mesh: n times the CPU, or the visible CUDA devices in turn (a card
    repeats when there are fewer than n, so one card holds any mesh)."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    devs = visible_devices()
    return [devs[i % len(devs)] for i in range(n)]


def build_mesh(
    n_replicas: int = 1,
    n_shards: Optional[int] = None,
    devices: Optional[Sequence[torch.device]] = None,
) -> Mesh:
    """A (replica, shard) mesh over the given devices (default: the visible CUDA devices).

    ``n_shards=None`` uses every remaining device for the shard axis."""
    devs = list(devices) if devices is not None else visible_devices()
    if n_shards is None:
        if len(devs) % n_replicas:
            raise ValueError(f"{len(devs)} devices not divisible by {n_replicas} replicas")
        n_shards = len(devs) // n_replicas
    need = n_replicas * n_shards
    if need > len(devs):
        raise ValueError(f"mesh {n_replicas}x{n_shards} needs {need} devices, have {len(devs)}")
    devs = devs[:need]
    return Mesh([devs[r * n_shards:(r + 1) * n_shards] for r in range(n_replicas)])
