"""The port's IVF index (mlvectordb_tpu_torch/store/ivf.py, ops/kmeans.py) on the CPU: the
cases of tests/test_ivf.py against the port, the IVF cases of tests/test_wal.py and
tests/test_engine.py, and parity with the JAX package.

Parity, numpy inputs from a seed through both packages:
  * ``assign_clusters``, ``assign_topm`` (planted ties: duplicated centroids, the lower id
    first) and ``update_centroids``: equal ids and counts; distances within 1e-6 of the
    f32 rounding scale ||row||^2 + ||c||^2 (the port sums in float64, the JAX package in
    f32), centroids within 1e-6 relative;
  * ``train_kmeans`` on well-separated clusters: JAX's assignment, and its centroids
    within 1e-5 (k-means++ init and the random-rows init of C > 1024);
  * a JAX-trained index carried across with ``convert.ivf_from_jax``: JAX's ids at
    nprobe 1, 2 and C, for l2, ip and cosine, f32 and bf16 stores, spill 1 and 2, with
    scores within 1e-5 relative (absolute: 1e-5, and for l2 1e-6 of ||q||^2 + ||x||^2,
    the scale of its f32 rounding); and after the same upserts and deletes through both
    engines.
"""

import uuid

import numpy as np
import pytest
import torch

from mlvectordb_tpu.config import EngineConfig as JaxConfig
from mlvectordb_tpu.engine.query_processor import QueryProcessor as JaxQueryProcessor
from mlvectordb_tpu.interfaces.vector import VectorDTO as JaxDTO
from mlvectordb_tpu.ops import kmeans as jkmeans
from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO, convert
from mlvectordb_tpu_torch.ops.kmeans import (assign_clusters, assign_topm, train_kmeans,
                                             update_centroids)

SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128), use_pallas=False)


@pytest.fixture
def cfg():
    return EngineConfig(**SMALL)


def _qp(cfg):
    return QueryProcessor(cfg, device="cpu")


def clustered_data(rng, n_clusters=8, per=40, dim=16, spread=0.05):
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3
    rows = np.concatenate(
        [c + spread * rng.standard_normal((per, dim)).astype(np.float32) for c in centers]
    )
    return rows, centers


def dto(vals, meta=None, vid=None):
    return VectorDTO(values=vals, metadata=meta, id=vid)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------------- k-means


def test_kmeans_recovers_clusters(rng):
    rows, centers = clustered_data(rng)
    cents, assign = train_kmeans(t(rows), torch.ones(rows.shape[0], dtype=torch.bool),
                                 n_clusters=8, n_iters=15, seed=1)
    a = assign.numpy()
    for g in range(8):
        block = a[g * 40 : (g + 1) * 40]
        assert (block == block[0]).all()
    c = cents.numpy()
    assert cents.dtype == torch.float32
    d = ((c[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    assert (d.min(axis=0) < 0.1).all()


def test_kmeans_update_step_is_cluster_mean(rng):
    rows = rng.standard_normal((100, 8)).astype(np.float32)
    assign = rng.integers(0, 4, 100).astype(np.int32)
    cents, counts = update_centroids(t(rows), t(assign), n_clusters=4)
    for c in range(4):
        sel = rows[assign == c]
        assert counts[c] == len(sel)
        np.testing.assert_allclose(cents.numpy()[c], sel.mean(0), rtol=1e-5, atol=1e-5)


def test_assign_respects_validity(rng):
    rows = rng.standard_normal((64, 8)).astype(np.float32)
    valid = np.ones(64, bool)
    valid[10] = False
    a, _ = assign_clusters(t(rows), t(valid), t(rows[:4]))
    assert a.numpy()[10] == -1
    assert (a.numpy()[:4] == np.arange(4)).all()  # centroid rows map to themselves


def _f32_scale(rows, cents):
    """||row||^2 + ||c||^2 of each row and its centroid: the scale of an f32 distance's
    rounding."""
    return (rows.astype(np.float64) ** 2).sum(-1)[:, None] + (
        cents.astype(np.float64) ** 2).sum(-1)[None, :]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_assign_clusters_matches_jax(rng, dtype):
    """The same rows (f32 or rounded to bf16) and centroids: the same ids, duplicated
    centroids (exact ties) taking the lower id in both; distances within 1e-6 of the f32
    rounding scale."""
    import jax.numpy as jnp

    rows = rng.standard_normal((3000, 32)).astype(np.float32)
    cents = rng.standard_normal((40, 32)).astype(np.float32)
    cents[7] = cents[3]      # planted ties: both packages must pick 3
    cents[20] = cents[31]    # ... and 20
    rows[:50] = cents[3] + 1e-3 * rows[:50]
    valid = rng.random(3000) > 0.1
    jrows = jnp.asarray(rows, dtype)
    trows = t(rows).to(getattr(torch, dtype))
    for chunk in (65536, 512):
        ja, jd = jkmeans.assign_clusters(jrows, jnp.asarray(valid), jnp.asarray(cents),
                                         chunk=chunk)
        ta, td = assign_clusters(trows, t(valid), t(cents), chunk=chunk)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        assert not np.isin(ta.numpy(), [7, 31]).any()
        scale = _f32_scale(trows.float().numpy(), cents)[np.arange(3000),
                                                          np.maximum(ta.numpy(), 0)]
        assert (np.abs(td.numpy() - np.asarray(jd, np.float32)) <= 1e-6 * scale).all()


@pytest.mark.parametrize("m", [1, 2, 3])
def test_assign_topm_matches_jax_with_planted_ties(rng, m):
    """The m nearest centroids, nearest first; among duplicated centroids (exact ties) the
    lower id first, as lax.top_k orders them."""
    import jax.numpy as jnp

    rows = rng.standard_normal((2000, 16)).astype(np.float32)
    cents = rng.standard_normal((24, 16)).astype(np.float32)
    for dup, src in ((5, 2), (9, 2), (17, 11), (23, 0)):
        cents[dup] = cents[src]
    rows[:100] = cents[2] + 1e-2 * rows[:100]     # their two nearest tie: 2 then 5, 9
    valid = np.ones(2000, bool)
    valid[::37] = False
    want = np.asarray(jkmeans.assign_topm(jnp.asarray(rows), jnp.asarray(valid),
                                          jnp.asarray(cents), m=m, chunk=512))
    got = assign_topm(t(rows), t(valid), t(cents), m=m, chunk=512).numpy()
    np.testing.assert_array_equal(got, want)
    if m >= 2:
        assert (got[1:100][valid[1:100]][:, :2] == [2, 5]).all()


def test_update_centroids_matches_jax(rng):
    import jax.numpy as jnp

    rows = rng.standard_normal((4096, 32)).astype(np.float32)
    assign = rng.integers(-1, 50, 4096).astype(np.int32)
    assign[assign == 13] = 14        # an empty cluster keeps a zero row
    for chunk in (65536, 1000):
        jc, jn = jkmeans.update_centroids(jnp.asarray(rows), jnp.asarray(assign),
                                          n_clusters=50, chunk=chunk)
        tc, tn = update_centroids(t(rows), t(assign), n_clusters=50, chunk=chunk)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
        assert tc.dtype == torch.float32 and not tc[13].any()


@pytest.mark.parametrize("n_clusters", [12, 1100])
def test_train_kmeans_matches_jax_on_separated_clusters(n_clusters):
    """Well-separated clusters: the port's k-means gives JAX's assignment, and its
    centroids within 1e-5 (k-means++ init at 12 clusters, random rows at 1100: the same
    draws from the seed in both)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    # random-row init puts several centroids in one cluster: its rows must stand well
    # apart from each other, or the f32 rounding of JAX's distances decides (the case
    # below)
    per, spread = (3, 0.3) if n_clusters > 1024 else (300, 0.01)
    rows, _ = clustered_data(rng, n_clusters=n_clusters, per=per, dim=16, spread=spread)
    rows = rows[rng.permutation(len(rows))]
    valid = np.ones(len(rows), bool)
    valid[::41] = False
    jc, ja = jkmeans.train_kmeans(jnp.asarray(rows), jnp.asarray(valid), n_clusters,
                                  n_iters=5, seed=3)
    tc, ta = train_kmeans(t(rows), t(valid), n_clusters, n_iters=5, seed=3)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)


def test_assign_near_tie_takes_the_nearest_centroid_where_jax_rounds(rng):
    """An intended divergence (ROADMAP C10): two centroids 1e-3 apart inside a cluster of
    rows with ||row||^2 ~ 150.  JAX's f32 distances ||row||^2 + ||c||^2 - 2 row.c carry a
    rounding error of ~1e-5 there, beyond some rows' gap between the two, and it assigns
    them to the farther centroid; the port's float64 distances assign every row to its
    nearest centroid (the float64 oracle's)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    rows, _ = clustered_data(rng, n_clusters=1100, per=3, dim=16, spread=0.01)
    rows = rows[rng.permutation(len(rows))]
    cents = rows[np.sort(np.random.default_rng(3).choice(len(rows), 1100, replace=False))]
    valid = np.ones(len(rows), bool)
    ja, _ = jkmeans.assign_clusters(jnp.asarray(rows), jnp.asarray(valid), jnp.asarray(cents))
    ta, _ = assign_clusters(t(rows), t(valid), t(cents))
    d64 = ((rows.astype(np.float64)[:, None, :] - cents.astype(np.float64)[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(ta.numpy(), d64.argmin(1))
    flipped = np.flatnonzero(np.asarray(ja) != d64.argmin(1))
    assert len(flipped) >= 1
    two = np.sort(d64[flipped], axis=1)[:, :2]
    assert ((two[:, 1] - two[:, 0]) < 1e-4).all()   # each a near tie at f32 resolution


def test_train_kmeans_is_independent_of_the_summation_order(rng):
    """k-means sums in float64: the same rows with their dimensions reversed (every sum in
    another order) train to the same assignment and centroids, where f32 sums would let a
    row on a centroid boundary flip and move every later iteration."""
    rows = np.concatenate([rng.standard_normal((900, 24)).astype(np.float32) * s
                           for s in (1.0, 2.5, 0.5)])
    valid = torch.ones(len(rows), dtype=torch.bool)
    c1, a1 = train_kmeans(t(rows), valid, 60, n_iters=10, seed=4)
    c2, a2 = train_kmeans(t(rows[:, ::-1]), valid, 60, n_iters=10, seed=4)
    np.testing.assert_array_equal(a1.numpy(), a2.numpy())
    np.testing.assert_allclose(c1.numpy(), c2.numpy()[:, ::-1], rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------------- IVF engine


@pytest.fixture
def ivf_qp(cfg, rng):
    qp = _qp(cfg)
    rows, _ = clustered_data(rng, n_clusters=8, per=40, dim=16)
    vs = qp.upsert_many([dto(r, {"i": i}) for i, r in enumerate(rows)], "ns")
    stats = qp.build_ivf("ns", n_clusters=8, n_iters=10, seed=0)
    assert stats["clusters"] == 8 and stats["live"] == len(vs)
    return qp, vs, rows


def test_full_probe_matches_exact(ivf_qp):
    qp, vs, rows = ivf_qp
    q = dto(rows[5])
    exact = qp.find_similar(q, top_k=10, namespace="ns", metric="l2")
    x0 = dict(qp.transfer_counts)
    approx = qp.find_similar(q, top_k=10, namespace="ns", metric="l2", nprobe=8)
    assert (qp.transfer_counts["h2d"] - x0["h2d"], qp.transfer_counts["d2h"] - x0["d2h"]) == (1, 1)
    assert [r["id"] for r in exact] == [r["id"] for r in approx]
    for e, a in zip(exact, approx):
        assert a["score"] == pytest.approx(e["score"], rel=1e-4, abs=1e-4)


def test_small_nprobe_finds_planted_neighbor(ivf_qp, rng):
    qp, vs, rows = ivf_qp
    for i in (3, 77, 200, 319):
        q = dto(rows[i] + 0.001 * rng.standard_normal(16).astype(np.float32))
        res = qp.find_similar(q, top_k=1, namespace="ns", metric="l2", nprobe=1)
        assert res[0]["id"] == vs[i].id


def test_recall_at_small_nprobe(ivf_qp, rng):
    qp, vs, rows = ivf_qp
    hits = total = 0
    for _ in range(20):
        q = rng.standard_normal(16).astype(np.float32)
        exact = {r["id"] for r in qp.find_similar(dto(q), 5, "ns", "l2")}
        approx = {r["id"] for r in qp.find_similar(dto(q), 5, "ns", "l2", nprobe=2)}
        hits += len(exact & approx)
        total += len(exact)
    assert hits / total >= 0.6  # random queries, 2/8 clusters probed


def test_ivf_tracks_mutations(ivf_qp, rng):
    qp, vs, rows = ivf_qp
    ns = qp.storage.namespace("ns")
    nv = qp.insert(dto(rows[0] * 0.999 + 0.001, {"new": True}), "ns")
    res = qp.find_similar(dto(nv.values), top_k=1, namespace="ns", nprobe=2)
    assert res[0]["id"] == nv.id
    qp.delete([vs[10].id], "ns")
    res = qp.find_similar(dto(rows[10]), top_k=5, namespace="ns", nprobe=8)
    assert vs[10].id not in [r["id"] for r in res]
    qp.upsert_many([dto(rows[20] + 5.0, {"v": 2}, vs[20].id)], "ns")
    res = qp.find_similar(dto(rows[20] + 5.0), top_k=1, namespace="ns", nprobe=8)
    assert res[0]["id"] == vs[20].id
    assert ns.ivf.live_count == ns.live_count


def test_nprobe_with_filter_falls_back_to_exact(ivf_qp):
    qp, vs, rows = ivf_qp
    res = qp.find_similar(
        dto(rows[0]), top_k=5, namespace="ns", nprobe=1, filter={"i": {"$lt": 100}}
    )
    assert len(res) == 5
    assert all(r["metadata"]["i"] < 100 for r in res)


def test_nprobe_without_index_uses_exact(cfg, rng):
    qp = _qp(cfg)
    vs = qp.upsert_many([dto(rng.standard_normal(8).astype(np.float32)) for _ in range(20)], "ns")
    res = qp.find_similar(dto(vs[0].values), top_k=1, namespace="ns", nprobe=4)
    assert res[0]["id"] == vs[0].id  # silently exact


def test_drop_ivf(ivf_qp):
    qp, vs, rows = ivf_qp
    assert qp.drop_ivf("ns") is True
    assert qp.drop_ivf("ns") is False
    res = qp.find_similar(dto(rows[0]), top_k=1, namespace="ns", nprobe=1)
    assert res[0]["id"] == vs[0].id  # exact path again


def test_ivf_stats_and_statistics_kind(ivf_qp):
    qp, vs, rows = ivf_qp
    ns = qp.storage.namespace("ns")
    st = ns.ivf.stats()
    assert st["live"] == ns.live_count
    assert st["fill_max"] <= st["cluster_capacity"]
    g = ns.ivf._gen
    assert st["memory_bytes"] == (g.data3.numel() * 4 + g.valid3.numel() + g.sqn3.numel() * 4)
    qp.find_similar(dto(rows[0]), top_k=1, namespace="ns", nprobe=2)
    assert qp.get_statistics()["queries_by_type"].get("ivf", 0) >= 1


def test_build_records_its_steps_as_spans(cfg, rng):
    """build_ivf records its k-means, assignment, host layout and device scatter as
    ``ivf_build.*`` spans inside its ``ivf_build`` span, once per build (the card's
    smoke reads the build's time split from them)."""
    from mlvectordb_tpu_torch.utils.tracing import RECORDER

    qp = _qp(cfg)
    rows, _ = clustered_data(rng, n_clusters=8, per=40, dim=16)
    qp.upsert_many([dto(r) for r in rows], "ns")
    steps = ["ivf_build.kmeans", "ivf_build.assign", "ivf_build.layout", "ivf_build.scatter"]
    before = {n: RECORDER.summary().get(n, {}).get("count", 0) for n in steps + ["ivf_build"]}
    qp.build_ivf("ns", n_clusters=8, n_iters=4, seed=0)
    recent = RECORDER.recent()
    for n in steps + ["ivf_build"]:
        assert RECORDER.summary()[n]["count"] == before[n] + 1, n
    last = {e["name"]: e for e in recent}
    assert [e["name"] for e in recent if e["name"] in steps][-4:] == steps
    assert sum(last[n]["elapsed_ms"] for n in steps) <= last["ivf_build"]["elapsed_ms"]


def test_ivf_skewed_clusters_overflow_placement(cfg, rng):
    """90% of rows in one blob: overflow rows land nearest-with-space (no crash), the
    index stays complete, and full-probe search remains exact."""
    blob = rng.standard_normal((180, 8)).astype(np.float32) * 0.05 + 5.0
    rest = rng.standard_normal((20, 8)).astype(np.float32) - 5.0
    rows = np.concatenate([blob, rest])
    qp = _qp(cfg)
    vs = qp.upsert_many([dto(r) for r in rows], "ns")
    stats = qp.build_ivf("ns", n_clusters=8, n_iters=8, seed=3)
    ns = qp.storage.namespace("ns")
    assert ns.ivf.live_count == 200
    assert stats["fill_max"] <= stats["cluster_capacity"]
    q = dto(rows[7])
    exact = qp.find_similar(q, top_k=10, namespace="ns", metric="l2")
    full = qp.find_similar(q, top_k=10, namespace="ns", metric="l2", nprobe=8)
    assert [r["id"] for r in exact] == [r["id"] for r in full]
    res = qp.find_similar(dto(rows[190]), top_k=1, namespace="ns", nprobe=1)
    assert res[0]["id"] == vs[190].id


# ------------------------------------------------------------------------- persistence


def test_ivf_snapshot_roundtrip_identical_results(ivf_qp, tmp_path, cfg):
    qp, vs, rows = ivf_qp
    queries = [dto(rows[i] + 0.01) for i in (0, 50, 150, 311)]
    before = [qp.find_similar(q, top_k=5, namespace="ns", metric="l2", nprobe=2) for q in queries]
    qp.save(str(tmp_path / "snap"))

    qp2 = QueryProcessor.load(str(tmp_path / "snap"), cfg, device="cpu")
    ns2 = qp2.storage.namespace("ns")
    assert ns2.ivf is not None
    after = [qp2.find_similar(q, top_k=5, namespace="ns", metric="l2", nprobe=2) for q in queries]
    for b_list, a_list in zip(before, after):
        assert [r["id"] for r in b_list] == [r["id"] for r in a_list]
        for b, a in zip(b_list, a_list):
            assert a["score"] == pytest.approx(b["score"], rel=1e-5, abs=1e-5)
    ivf1 = qp.storage.namespace("ns").ivf
    assert ivf1._id_to_slot == ns2.ivf._id_to_slot
    np.testing.assert_array_equal(ivf1.centroids.numpy(), ns2.ivf.centroids.numpy())


def test_snapshot_without_ivf_still_loads(ivf_qp, tmp_path, cfg):
    qp, vs, rows = ivf_qp
    qp.drop_ivf("ns")
    qp.save(str(tmp_path / "snap"))
    qp2 = QueryProcessor.load(str(tmp_path / "snap"), cfg, device="cpu")
    assert qp2.storage.namespace("ns").ivf is None


# ------------------------------------------------------------------------- drift


def test_drift_triggers_retrain(cfg, rng):
    qp = _qp(cfg)
    rows, centers = clustered_data(rng, n_clusters=8, per=40, dim=16)
    vs = qp.upsert_many([dto(r, {"i": i}) for i, r in enumerate(rows)], "ns")
    qp.build_ivf("ns", n_clusters=8, n_iters=10, seed=0)
    ivf = qp.storage.namespace("ns").ivf
    assert ivf._drift == 0
    moved = [(vs[i].id, rows[7 * 40 + (i % 40)] + 0.01) for i in range(0, 100)]
    qp.upsert_many([dto(v, {"moved": True}, vid) for vid, v in moved], "ns")
    assert ivf._drift / max(1, ivf.live_count) < cfg.rebuild_threshold
    hits = qp.find_similar(dto(moved[3][1]), top_k=1, namespace="ns", metric="l2", nprobe=1)
    assert hits[0]["id"] == moved[3][0]


def test_drift_counts_deletes_and_stats_expose_ratio(ivf_qp):
    qp, vs, rows = ivf_qp
    ivf = qp.storage.namespace("ns").ivf
    qp.delete([vs[0].id, vs[1].id], "ns")
    s = ivf.stats()
    assert s["drift"] >= 2 or s["drift"] == 0  # 0 iff the delete crossed the retrain bar
    assert "drift_ratio" in s


# ------------------------------------------------------------------------- spill


def test_spill_improves_recall_at_fixed_nprobe(cfg, rng):
    rows, centers = clustered_data(rng, n_clusters=8, per=40, dim=16, spread=0.8)
    queries = rows[rng.integers(0, len(rows), 24)] + 0.05 * rng.standard_normal(
        (24, 16)).astype(np.float32)
    d = ((rows[None, :, :] - queries[:, None, :]) ** 2).sum(-1)
    true5 = [set(np.argsort(d[i])[:5].tolist()) for i in range(24)]
    recalls = {}
    for spill in (1, 2):
        qp = _qp(cfg)
        qp.upsert_many([dto(r, {"i": i}) for i, r in enumerate(rows)], "ns")
        ns = qp.storage.namespace("ns")
        qp.build_ivf("ns", n_clusters=8, n_iters=10, seed=0, spill=spill)
        hits = 0
        for i, q in enumerate(queries):
            got = qp.find_similar(dto(q), top_k=5, namespace="ns", metric="l2", nprobe=1)
            got_rows = {ns._id_to_slot[r["id"]] for r in got}
            hits += len(got_rows & true5[i])
        recalls[spill] = hits / (24 * 5)
    assert recalls[2] >= recalls[1], recalls
    assert recalls[2] > 0.8, recalls


def test_spill_no_duplicate_ids_and_k_respected(cfg, rng):
    rows, _ = clustered_data(rng, n_clusters=8, per=40, dim=16)
    qp = _qp(cfg)
    qp.upsert_many([dto(r) for r in rows], "ns")
    stats = qp.build_ivf("ns", n_clusters=8, spill=2)
    assert stats["spill"] == 2 and stats["copies"] > stats["live"]
    for nprobe in (2, 8):
        got = qp.find_similar(dto(rows[7]), top_k=10, namespace="ns", metric="l2", nprobe=nprobe)
        ids = [r["id"] for r in got]
        assert len(ids) == len(set(ids)) == 10
    exact = qp.find_similar(dto(rows[7]), top_k=10, namespace="ns", metric="l2")
    approx = qp.find_similar(dto(rows[7]), top_k=10, namespace="ns", metric="l2", nprobe=8)
    assert [r["id"] for r in exact] == [r["id"] for r in approx]


def test_spill_tracks_mutations_and_snapshots(cfg, rng, tmp_path):
    rows, _ = clustered_data(rng, n_clusters=8, per=30, dim=16)
    qp = _qp(cfg)
    vs = qp.upsert_many([dto(r) for r in rows], "ns")
    qp.build_ivf("ns", n_clusters=8, spill=2)
    ivf = qp.storage.namespace("ns").ivf
    nv = qp.insert(dto(rows[3] + 0.01), "ns")
    assert nv.id in ivf._id_to_slot
    moved = rows[100] + 0.02
    qp.upsert_many([dto(moved, None, vs[5].id)], "ns")
    got = qp.find_similar(dto(moved), top_k=1, namespace="ns", metric="l2", nprobe=8)
    assert got[0]["id"] == vs[5].id and got[0]["score"] < 1e-3
    qp.delete([vs[5].id], "ns")
    got = qp.find_similar(dto(moved), top_k=10, namespace="ns", metric="l2", nprobe=8)
    assert all(r["id"] != vs[5].id for r in got)
    assert vs[5].id not in ivf._extra_slots
    qp.save(str(tmp_path / "snap"))
    qp2 = QueryProcessor.load(str(tmp_path / "snap"), cfg, device="cpu")
    ivf2 = qp2.storage.namespace("ns").ivf
    assert ivf2.spill == 2
    assert ivf2._id_to_slot == ivf._id_to_slot
    assert {k: sorted(v) for k, v in ivf2._extra_slots.items()} == {
        k: sorted(v) for k, v in ivf._extra_slots.items()
    }
    q = rows[20]
    a = qp.find_similar(dto(q), top_k=5, namespace="ns", metric="l2", nprobe=2)
    b = qp2.find_similar(dto(q), top_k=5, namespace="ns", metric="l2", nprobe=2)
    assert [r["id"] for r in a] == [r["id"] for r in b]


def test_ivf_rebuild_invalidates_result_cache(ivf_qp, rng):
    qp, vs, rows = ivf_qp
    q = dto(rows[11] + 0.01)
    qp.find_similar(q, top_k=3, namespace="ns", metric="l2", nprobe=1)
    ns = qp.storage.namespace("ns")
    v_before = ns.version
    qp.build_ivf("ns", n_clusters=8, n_iters=10, seed=3, spill=2)
    assert ns.version > v_before
    second = qp.find_similar(q, top_k=3, namespace="ns", metric="l2", nprobe=1)
    assert second
    v_mid = ns.version
    qp.drop_ivf("ns")
    assert ns.version > v_mid
    exact = qp.find_similar(q, top_k=3, namespace="ns", metric="l2", nprobe=1)
    assert [r["id"] for r in exact] == [
        r["id"] for r in qp.find_similar(q, top_k=3, namespace="ns", metric="l2")
    ]


# ------------------------------------------------------------------------- engine, WAL


def test_bulk_load_keeps_ivf_in_sync(cfg, rng):
    """tests/test_engine.py's IVF case."""
    qp = _qp(cfg)
    vals = rng.standard_normal((100, 8)).astype(np.float32)
    qp.bulk_load(vals, "ns")
    qp.build_ivf("ns", n_clusters=4)
    new_vals = rng.standard_normal((20, 8)).astype(np.float32)
    new_ids = qp.bulk_load(new_vals, "ns")
    res = qp.find_similar(dto(new_vals[3]), top_k=1, namespace="ns", nprobe=4)
    assert res[0]["id"] == new_ids[3]


def test_wal_covers_ivf_lifecycle(tmp_path, cfg, rng):
    """tests/test_wal.py's IVF case: bulk_load -> build_ivf -> crash -> WAL-only recovery
    serves nprobe from the same index; a logged drop is not undone by recovery."""
    wal_dir = str(tmp_path / "wal")
    qp = _qp(cfg)
    qp.enable_wal(wal_dir)
    vals = rng.standard_normal((300, 8)).astype(np.float32)
    qp.bulk_load(vals, "ns")
    stats = qp.build_ivf("ns", n_clusters=8, seed=5)
    pre = qp.find_similar(dto(vals[7]), top_k=5, namespace="ns", nprobe=8)
    qp2 = QueryProcessor.load(str(tmp_path / "nonexistent"), cfg, wal_path=wal_dir,
                              device="cpu")
    ns2 = qp2.storage.namespace("ns")
    assert ns2.ivf is not None, "recovered server silently lost its IVF index"
    assert ns2.ivf.C == stats["clusters"] and ns2.ivf.spill == stats["spill"]
    post = qp2.find_similar(dto(vals[7]), top_k=5, namespace="ns", nprobe=8)
    assert [r["id"] for r in post] == [r["id"] for r in pre]
    np.testing.assert_array_equal(ns2.ivf.centroids.numpy(),
                                  qp.storage.namespace("ns").ivf.centroids.numpy())
    qp2.drop_ivf("ns")
    qp3 = QueryProcessor.load(str(tmp_path / "nonexistent"), cfg, wal_path=wal_dir,
                              device="cpu")
    assert qp3.storage.namespace("ns").ivf is None


# ------------------------------------------------------------------------- parity


@pytest.mark.parametrize("centroids", ["jax_trained", "duplicated"])
@pytest.mark.parametrize("spill", [1, 2, 3])
def test_build_places_like_jax_with_the_same_centroids(spill, centroids, monkeypatch):
    """Given the same centroids, the build places every id as the JAX package's loop
    does: the same primary and spill slots (in the same insertion order), the overflow of
    full clusters into the nearest cluster with space, the same fill counts and cluster
    arrays.  70% of the rows sit in one blob, so most of them overflow.  With duplicated
    centroids every overflowed row meets exact ties, which the JAX loop breaks by its
    argsort's order."""
    import jax.numpy as jnp
    from mlvectordb_tpu.store import ivf as jax_ivf_mod

    from mlvectordb_tpu_torch.store import ivf as ivf_mod

    rng = np.random.default_rng(8)
    rows = np.concatenate([rng.standard_normal((420, 16)).astype(np.float32) * 0.3 + 2.0,
                           rng.standard_normal((180, 16)).astype(np.float32) * 3.0])
    rows = rows[rng.permutation(len(rows))]
    ids = [uuid.UUID(int=i + 1) for i in range(len(rows))]
    jqp = JaxQueryProcessor(config=JaxConfig(**SMALL))
    tqp = QueryProcessor(EngineConfig(**SMALL), device="cpu")
    for qp in (jqp, tqp):
        qp.bulk_load(rows, "ns", ids=ids)
        qp.delete(ids[::50], "ns")
    padded = np.pad(rows, ((0, 0), (0, 112)))
    if centroids == "duplicated":
        planted = padded[rng.choice(len(rows), 16, replace=False)]
        planted[[5, 9, 14]] = planted[3]
        monkeypatch.setattr(jax_ivf_mod, "train_kmeans",
                            lambda *a, **k: (jnp.asarray(planted), None))
    jqp.build_ivf("ns", n_clusters=16, cluster_capacity=48 * spill, seed=1, spill=spill)
    jivf = jqp.storage.namespace("ns").ivf
    cents = torch.from_numpy(np.array(jivf.centroids))
    monkeypatch.setattr(ivf_mod, "train_kmeans", lambda *a, **k: (cents, None))
    tqp.build_ivf("ns", n_clusters=16, cluster_capacity=48 * spill, seed=1, spill=spill)
    tivf = tqp.storage.namespace("ns").ivf
    near = assign_topm(t(padded), torch.ones(len(rows), dtype=torch.bool), cents, m=1)[:, 0]
    moved = sum(jivf._id_to_slot[vid] // jivf.L != int(near[i])
                for i, vid in enumerate(ids) if vid in jivf._id_to_slot)
    assert moved > 20        # full clusters: that many primaries overflowed elsewhere
    assert list(tivf._id_to_slot.items()) == list(jivf._id_to_slot.items())
    assert list(tivf._extra_slots.items()) == list(jivf._extra_slots.items())
    assert tivf._free_per_cluster == jivf._free_per_cluster
    assert tivf._slot_ids == jivf._slot_ids
    np.testing.assert_array_equal(tivf.data3.numpy(), np.asarray(jivf.data3))
    np.testing.assert_array_equal(tivf.valid3.numpy(), np.asarray(jivf.valid3))


def _pair(dtype, n=3000, dim=24, twin=False):
    """A JAX and a port processor holding the same clustered rows under the same ids
    (``twin``: the JAX one written them rounded to bf16, the values a bf16 store holds)."""
    rng = np.random.default_rng(5)
    rows, _ = clustered_data(rng, n_clusters=30, per=n // 30, dim=dim, spread=0.6)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, len(rows))]
    metas = [{"i": i} for i in range(len(rows))]
    jqp = JaxQueryProcessor(config=JaxConfig(**SMALL, dtype=dtype))
    tqp = QueryProcessor(EngineConfig(**SMALL, dtype=dtype), device="cpu")
    stored = torch.from_numpy(rows).to(torch.bfloat16).float().numpy() if twin else rows
    for qp, values in ((jqp, stored), (tqp, rows)):
        qp.bulk_load(values, "ns", ids=ids, metadatas=metas)
    queries = rows[rng.integers(0, len(rows), 6)] + 0.3 * rng.standard_normal(
        (6, dim)).astype(np.float32)
    return jqp, tqp, rows, ids, queries, rng


def _carry_across(jqp, tqp):
    ns = tqp.storage.namespace("ns")
    ns.ivf = convert.ivf_from_jax(jqp.storage.namespace("ns").ivf, ns)
    ns.version += 1


def _assert_same_ivf_answers(jqp, tqp, queries, nprobes, metrics=("l2", "ip", "cosine"),
                             twin=False):
    """``twin``: ``jqp`` was written the bf16-rounded rows, which it hydrates."""
    for metric in metrics:
        for nprobe in nprobes:
            jr = jqp.find_similar_batch([JaxDTO(q) for q in queries], 10, "ns", metric,
                                        nprobe=nprobe)
            tr = tqp.find_similar_batch([VectorDTO(q) for q in queries], 10, "ns", metric,
                                        nprobe=nprobe)
            for q, a, b in zip(queries, jr, tr):
                assert len(b) == 10 and [r["id"] for r in a] == [r["id"] for r in b], (
                    metric, nprobe)
                # an l2 score qn + ||x||^2 - 2 q.x carries the rounding of its terms:
                # 1e-6 of ||q||^2 + ||x||^2 absolute (the two packages sum q.x in
                # different orders)
                scale = float(q @ q) + max(float(r["values"] @ r["values"]) for r in a)
                np.testing.assert_allclose([r["score"] for r in b], [r["score"] for r in a],
                                           rtol=1e-5,
                                           atol=1e-6 * scale if metric == "l2" else 1e-5)
                for ra, rb in zip(a, b):
                    assert ra["metadata"] == rb["metadata"]
                    got = torch.from_numpy(rb["values"])
                    np.testing.assert_array_equal(
                        ra["values"], (got.to(torch.bfloat16).float() if twin else got).numpy())


@pytest.mark.parametrize("spill", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_carried_jax_index_gives_jax_ids(dtype, spill):
    """A JAX-trained index carried across: the same layout (every id in its slot, spill
    copies too), and JAX's ids at nprobe 1, 2 and C for every metric.  The index's norms
    are its store's, which on a bf16 store are the stored rows' (ROADMAP C17), so there
    the JAX side is its twin, written the bf16-rounded rows; a JAX store written the f32
    rows gives its index the written rows' norms (asserted)."""
    bf16 = dtype == "bfloat16"
    jqp, tqp, rows, ids, queries, _ = _pair(dtype, twin=bf16)
    jqp.build_ivf("ns", n_clusters=16, seed=2, spill=spill)
    _carry_across(jqp, tqp)
    jivf, tivf = jqp.storage.namespace("ns").ivf, tqp.storage.namespace("ns").ivf
    assert tivf._id_to_slot == jivf._id_to_slot and tivf._extra_slots == jivf._extra_slots
    assert tivf.data3.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(tivf.valid3.numpy(), np.asarray(jivf.valid3))
    # the norms are each store's own (the two sum a row's squares in different orders)
    np.testing.assert_allclose(tivf.sqn3.numpy(), np.asarray(jivf.sqn3), rtol=1e-6)
    np.testing.assert_array_equal(tivf.data3.float().numpy(),
                                  np.asarray(jivf.data3, np.float32))
    _assert_same_ivf_answers(jqp, tqp, queries, (1, 2, 16), twin=bf16)
    if bf16:
        written = _pair(dtype)[0]
        written.build_ivf("ns", n_clusters=16, seed=2, spill=spill)
        wivf = written.storage.namespace("ns").ivf
        assert wivf._id_to_slot == jivf._id_to_slot
        np.testing.assert_array_equal(np.asarray(wivf.data3, np.float32),
                                      np.asarray(jivf.data3, np.float32))
        live = np.asarray(wivf.valid3)
        off = np.abs(np.asarray(wivf.sqn3) - tivf.sqn3.numpy()) > 1e-6 * tivf.sqn3.numpy()
        assert off[live].mean() > 0.9


def test_carried_index_follows_the_same_writes_as_jax():
    """The engine after the same upserts (new ids, overwrites that move rows) and deletes
    through both packages: the same index layout and JAX's ids."""
    jqp, tqp, rows, ids, queries, rng = _pair("float32")
    jqp.build_ivf("ns", n_clusters=16, seed=2, spill=2)
    _carry_across(jqp, tqp)
    fresh = rng.standard_normal((40, rows.shape[1])).astype(np.float32) * 3
    new_ids = [uuid.UUID(int=i + 7) for i in range(40)]
    moved = rows[rng.integers(0, len(rows), 30)] + 0.1
    over = [ids[i] for i in rng.choice(len(ids), 30, replace=False)]
    gone = [ids[i] for i in rng.choice(len(ids), 60, replace=False)]
    for qp, mk in ((jqp, JaxDTO), (tqp, VectorDTO)):
        qp.upsert_many([mk(v, {"new": i}, vid) for i, (v, vid) in enumerate(zip(fresh, new_ids))],
                       "ns")
        qp.upsert_many([mk(v, {"moved": i}, vid) for i, (v, vid) in enumerate(zip(moved, over))],
                       "ns")
        qp.bulk_load(fresh[:5] * 0.5, "ns", ids=new_ids[:5])
        qp.delete(gone, "ns")
    jivf, tivf = jqp.storage.namespace("ns").ivf, tqp.storage.namespace("ns").ivf
    assert tivf._id_to_slot == jivf._id_to_slot and tivf._extra_slots == jivf._extra_slots
    assert tivf._drift == jivf._drift
    _assert_same_ivf_answers(jqp, tqp, np.concatenate([queries, fresh[:3], moved[:3]]),
                             (1, 2, 16))
