"""One step of every distributed path: the counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``.

    python -m mlvectordb_tpu_torch.parallel.dryrun [N] [--device cpu]

builds an ``(R, N/R)`` mesh (R = 2 when N is even) over N devices (the visible CUDA
devices in turn, or N times the CPU) and runs one step of sharded upsert, search, the
sweep mirror's sharded search, replica reconcile and the cluster-sharded IVF probe,
checking each, then prints the JAX entry point's OK line.  Torch fixes no device count
at first use, so it runs in the calling process whatever that process did before.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import EngineConfig
from ..interfaces.vector import VectorDTO
from . import build_mesh, make_distributed_processor
from .mesh import mesh_devices


def _on_mesh(state, mesh) -> bool:
    """Every cell of the snapshot holds its shard on its own mesh device."""
    return [[st.data.device for st in row] for row in state.shards] == mesh.devices


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    n_replicas = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_shards = n_devices // n_replicas
    mesh = build_mesh(n_replicas, n_shards, devices=mesh_devices(n_devices, device))
    config = EngineConfig(
        initial_capacity=64,
        capacity_multiple=32,
        db_tile=64,
        query_buckets=(8, 64),
        k_buckets=(8, 32),
        use_pallas=False,
    )
    qp = make_distributed_processor(config=config, mesh=mesh)
    rng = np.random.default_rng(1)
    dim = 32

    # one serving step: sharded batch upsert (rows routed by uuid -> shard) ...
    vs = qp.upsert_many(
        [VectorDTO(rng.standard_normal(dim).astype(np.float32), {"i": i}) for i in range(64)],
        "dryrun",
    )
    ns = qp.storage.namespace("dryrun")
    state = ns.device_state()
    assert _on_mesh(state, mesh), state

    # ... + the sharded search (per-shard kNN, merge-top-k over the shards), with the
    # query batch split over the replicas
    qpad = torch.zeros((8, ns.dpad), dtype=torch.float32, device=mesh.home)
    qpad[:, :dim] = torch.from_numpy(np.stack([vs[i].values for i in range(8)]))
    dist, idx = qp.sharding_manager.sharded_knn(qpad, state.shards, k=4, metric="l2",
                                                db_tile=64)
    dist = dist.cpu().numpy()
    assert dist.shape == (8, 4) and (dist[:, 0] < 1e-5).all(), dist[:, 0]

    # end to end through the engine (hydration included) + replica consistency
    res = qp.find_similar(VectorDTO(vs[3].values), top_k=2, namespace="dryrun", metric="l2")
    assert res[0]["id"] == vs[3].id
    report = qp.replication_manager.reconcile(state.data, state.valid)
    assert report["consistent"], report

    # ... + one sweep-mirror shard search step: an f32 sweep mirror (the rows
    # themselves) per shard, searched through sharded_knn's sweep branch
    config_t = EngineConfig(
        initial_capacity=4096,
        capacity_multiple=4096,   # the mirror needs whole SWEEP_TILE (4096)-row shards
        db_tile=64,
        query_buckets=(8, 64),
        k_buckets=(8, 32),
        use_pallas=False,
        sweep_dtype="float32",
    )
    qp_t = make_distributed_processor(config=config_t, mesh=mesh)
    vs_t = qp_t.upsert_many(
        [VectorDTO(rng.standard_normal(dim).astype(np.float32), {"i": i}) for i in range(64)],
        "dryrun",
    )
    st_t = qp_t.storage.namespace("dryrun").device_state()
    assert all(st.mirror is not None for row in st_t.shards for st in row)
    assert _on_mesh(st_t, mesh)
    q_t = torch.zeros((8, ns.dpad), dtype=torch.float32, device=mesh.home)
    q_t[:, :dim] = torch.from_numpy(np.stack([vs_t[i].values for i in range(8)]))
    dist_t, _ = qp_t.sharding_manager.sharded_knn(q_t, st_t.shards, k=4, metric="l2",
                                                  db_tile=64)
    dist_t = dist_t.cpu().numpy()
    assert dist_t.shape == (8, 4) and (dist_t[:, 0] < 1e-5).all(), dist_t[:, 0]
    res_t = qp_t.find_similar(VectorDTO(vs_t[2].values), top_k=2, namespace="dryrun",
                              metric="l2")
    assert res_t[0]["id"] == vs_t[2].id

    # ... + one cluster-sharded IVF probe step (each shard holds C/S inverted lists)
    stats = qp.build_ivf("dryrun", n_clusters=2 * n_shards)
    assert stats["sharded"] and stats["shards"] == n_shards, stats
    g = ns.ivf._gen
    assert [[t.device for t in row] for row in g.data3] == mesh.devices
    assert all(t.shape[0] == 2 for row in g.data3 for t in row)
    res = qp.find_similar(VectorDTO(vs[5].values), top_k=2, namespace="dryrun",
                          nprobe=2 * n_shards)
    assert res[0]["id"] == vs[5].id  # full probe = exact
    print(
        f"dryrun_multichip OK: mesh replica={n_replicas} x shard={n_shards}, "
        f"sharded upsert+search+sweep-mirror+reconcile+ivf-probe ran one step"
    )


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_devices", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
