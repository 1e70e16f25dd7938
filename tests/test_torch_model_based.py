"""Model-based test of the port: random operation sequences against a naive model (a dict
of rows and a numpy brute force), as tests/test_model_based.py does for the JAX package.

The engine (device arrays, tombstones, compaction, bucketing, caches, native filter
masks, the certified sweep, snapshots, the write-ahead log and offload) must be
observationally equal to the model under any interleaving of upsert, overwrite, delete,
compaction, bulk load, snapshot round trip, crash and WAL replay, offload, and
(filtered) searches.  The engine is exact, so each comparison is an equality on neighbour
sets (ties may permute, at equal scores to 4 decimals).  The CPU cases run in Tier 1;
the ``gpu`` case runs the same sequences on the card.  The ``sharded`` kind (the
``"sharded"`` kind of tests/test_model_based.py) runs them on a distributed engine of a
(2, 4) mesh, restored into a fresh distributed engine at every snapshot round trip and
crash (the snapshot loaded into its sharded storage, then the WAL replayed).  The model evaluates filters with
the port's ``matches_filter``, whose semantics tests/test_torch_filters.py holds to the
JAX package's (this file imports no JAX, so it also runs with ``--noconftest``).
"""

import random
import uuid

import numpy as np
import pytest
import torch

from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.config import HIGHER_IS_BETTER
from mlvectordb_tpu_torch.filters import matches_filter
from mlvectordb_tpu_torch.utils.health import check_store_invariants

SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128))
CONFIGS = {
    "scan": dict(SMALL, use_pallas=False),
    "row_major": dict(SMALL),
    # two 4,096-row tiles from the start: every search runs the certified sweep
    "bf16_sweep": dict(SMALL, initial_capacity=8192, sweep_dtype="bfloat16"),
}


class NaiveModel:
    """Dict of rows and a numpy brute force: obviously correct semantics."""

    def __init__(self):
        self.ns = {}  # name -> {uuid: (values, metadata)}

    def upsert(self, name, items):
        self.ns.setdefault(name, {})
        for vid, vals, meta in items:
            self.ns[name][vid] = (vals, meta)

    def delete(self, name, ids):
        removed = []
        for vid in ids:
            if vid in self.ns.get(name, {}):
                del self.ns[name][vid]
                removed.append(vid)
        if name in self.ns and not self.ns[name]:
            del self.ns[name]
        return removed

    def search(self, name, q, k, metric, flt=None):
        rows = [(vid, vals) for vid, (vals, meta) in self.ns.get(name, {}).items()
                if matches_filter(meta or {}, flt)]
        if not rows or k <= 0:
            return []
        db = np.stack([r[1] for r in rows])
        dots = db @ q
        if metric == "l2":
            d = ((db - q) ** 2).sum(-1)
        elif metric == "ip":
            d = 1.0 - dots
        else:
            d = 1.0 - dots / np.maximum(np.linalg.norm(db, axis=1) * np.linalg.norm(q), 1e-30)
        order = np.argsort(d, kind="stable")[:k]
        return [(rows[i][0], float(d[i])) for i in order]


def _distributed(cfg, device):
    from mlvectordb_tpu_torch.parallel import make_distributed_processor

    return make_distributed_processor(2, 4, cfg, devices=[torch.device(device)] * 8)


def _recover(snap, cfg, wal, device, sharded):
    """The processor a restart brings up: the snapshot, then the WAL on top."""
    if not sharded:
        return QueryProcessor.load(snap, cfg, wal_path=wal, device=device)
    from mlvectordb_tpu_torch.engine.persist import load_storage, resolve_snapshot_dir

    qp = _distributed(cfg, device)
    found = resolve_snapshot_dir(snap)
    if found is not None:
        load_storage(found, cfg, storage=qp.storage)
    qp.replay_wal(wal)
    qp.enable_wal(wal)
    return qp


def run_sequence(cfg, device, seed, tmp_path, steps=120, sharded=False):
    rnd = random.Random(seed)
    nprng = np.random.default_rng(seed)
    dim = 12
    snap, wal = str(tmp_path / "snap"), str(tmp_path / "wal")
    qp = _distributed(cfg, device) if sharded else QueryProcessor(cfg, device=device)
    qp.enable_wal(wal)
    model = NaiveModel()
    namespaces = ["a", "b"]
    all_ids = []
    ops = {}

    def rand_meta(i):
        return {"i": i, "grp": rnd.choice(["x", "y", "z"]), "f": rnd.random()}

    def check_search(step, name):
        q = nprng.standard_normal(dim).astype(np.float32)
        metric = rnd.choice(["l2", "ip", "cosine"])
        k = rnd.randint(1, 8)
        flt = rnd.choice([None, None, {"grp": "x"}, {"i": {"$gte": 0}}, {"f": {"$lt": 0.5}}])
        got = qp.find_similar(VectorDTO(q), k, name, metric, filter=flt)
        want = model.search(name, q, k, metric, flt)
        ns = qp.storage.namespace(name)
        if ns is not None:
            st = ns.device_state()
            if (st.shards[0][0] if sharded else st).mirror is not None:
                ops["on_the_sweep"] = ops.get("on_the_sweep", 0) + 1
        assert len(got) == len(want), f"step {step}: {len(got)} vs {len(want)}"
        got_ids, want_ids = [r["id"] for r in got], [w[0] for w in want]
        if got_ids != want_ids:   # permutations among equal scores only
            gs = [round(r["score"], 4) for r in got]
            ws = [round(1.0 - w[1], 4) if HIGHER_IS_BETTER[metric] else round(w[1], 4)
                  for w in want]
            assert gs == ws, f"step {step}: scores {gs} vs {ws}"
            assert set(got_ids) == set(want_ids), f"step {step}"

    for step in range(steps):
        op = rnd.random()
        name = rnd.choice(namespaces)
        if op < 0.33:  # batch insert
            items, dtos = [], []
            for j in range(rnd.randint(1, 12)):
                vid = uuid.uuid4()
                vals = nprng.standard_normal(dim).astype(np.float32)
                meta = rand_meta(step * 100 + j)
                items.append((vid, vals, meta))
                dtos.append(VectorDTO(vals, meta, id=vid))
                all_ids.append((name, vid))
            qp.upsert_many(dtos, name)
            model.upsert(name, items)
            kind = "insert"
        elif op < 0.42 and all_ids:  # overwrite an existing id
            name, vid = rnd.choice(all_ids)
            vals = nprng.standard_normal(dim).astype(np.float32)
            meta = rand_meta(step)
            qp.upsert_many([VectorDTO(vals, meta, id=vid)], name)
            model.upsert(name, [(vid, vals, meta)])
            kind = "overwrite"
        elif op < 0.55 and all_ids:  # delete a few (ghosts included)
            picks = [rnd.choice(all_ids) for _ in range(rnd.randint(1, 5))]
            ids = [vid for _, vid in picks if rnd.random() < 0.9] + [uuid.uuid4()]
            assert set(qp.delete(ids, name)) == set(model.delete(name, ids)), f"step {step}"
            kind = "delete"
        elif op < 0.58:  # explicit compaction
            ns = qp.storage.namespace(name)
            if ns is not None:
                ns.compact()
            kind = "compact"
        elif op < 0.61:  # the vectorized bulk path
            n = rnd.randint(1, 20)
            vals = nprng.standard_normal((n, dim)).astype(np.float32)
            metas = [rand_meta(step * 1000 + j) for j in range(n)]
            new_ids = qp.bulk_load(vals, name, metadatas=metas)
            model.upsert(name, list(zip(new_ids, vals, metas)))
            all_ids.extend((name, vid) for vid in new_ids)
            kind = "bulk"
        elif op < 0.64:  # snapshot round trip: save, then serve the loaded snapshot + log
            qp.save(snap)
            qp = _recover(snap, cfg, wal, device, sharded)
            kind = "save_load"
        elif op < 0.67:  # crash: abandon the processor, recover snapshot + WAL replay
            qp = _recover(snap, cfg, wal, device, sharded)
            kind = "crash_replay"
        elif op < 0.70:  # offload a namespace; the next search pages it in
            qp.offload_namespace(name)
            check_search(step, name)
            kind = "offload_search"
        else:
            check_search(step, name)
            kind = "search"
        ops[kind] = ops.get(kind, 0) + 1

    # every namespace's whole content matches the model, and survives one more crash
    for final in (qp, _recover(snap, cfg, wal, device, sharded)):
        for name in namespaces:
            rows = model.ns.get(name, {})
            assert final.get_namespace_count(name) == len(rows)
            for vid, (vals, meta) in rows.items():
                got = final.storage.read(vid, name)
                assert got is not None
                np.testing.assert_array_equal(got.values, vals)
                assert got.metadata == meta
        assert check_store_invariants(final.storage)["ok"]
    return ops


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_operation_sequences(tmp_path, seed, config):
    ops = run_sequence(EngineConfig(**CONFIGS[config]), "cpu", seed, tmp_path)
    assert ops["search"] > 20 and ops["insert"] > 20
    assert all(ops.get(kind, 0) >= 1 for kind in (
        "overwrite", "delete", "compact", "bulk", "save_load", "crash_replay",
        "offload_search"))
    assert (ops.get("on_the_sweep", 0) > 20) == (config == "bf16_sweep")


@pytest.mark.parametrize("config", ["row_major", "bf16_sweep"])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_operation_sequences_sharded(tmp_path, seed, config):
    """The sequences on a (2, 4) distributed engine: the row-major kernel per shard, or
    (8,192-row shards from the start) the certified sweep per shard."""
    cfg = dict(CONFIGS[config])
    if config == "bf16_sweep":
        cfg["initial_capacity"] = 4 * 8192
    ops = run_sequence(EngineConfig(**cfg), "cpu", seed, tmp_path, sharded=True)
    assert ops["search"] > 20 and ops["insert"] > 20
    assert all(ops.get(kind, 0) >= 1 for kind in (
        "overwrite", "delete", "compact", "bulk", "save_load", "crash_replay",
        "offload_search"))
    assert (ops.get("on_the_sweep", 0) > 20) == (config == "bf16_sweep")


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["row_major", "bf16_sweep"])
def test_random_operation_sequences_on_the_card(tmp_path, config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in (0, 1):
        run_sequence(EngineConfig(**CONFIGS[config]), "cuda", seed, tmp_path / str(seed))
