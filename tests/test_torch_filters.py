"""Metadata filters and hybrid search of the port, against the JAX package on the CPU.

The filter mini-language (``matches_filter``) is held case by case to the JAX package's.
Filtered searches run through a JAX QueryProcessor and the port's (device="cpu") on the
same seeded corpora under the same uuids: the JAX side's Pallas kernels in interpret mode
(its backend is told it runs on a TPU, as tests/test_torch_engine.py does), the port's
kernels as their plain torch versions.  Every configuration the port serves is covered:
the row-major path over f32 and bf16 rows (kernel B5 over a filtered ``valid``), the
certified sweep over the bf16, int8 and f32 mirrors and a bf16 store's own rows (B1/B3
over a masked bias row, B2), at k = 10 and 100, with filters matching 0, 3, k - 1, k and
half the rows, before and after deletes and after a compaction.

Rules held against JAX on every search:
  * the same ids, with scores within 1e-5 relative and 1e-4 absolute (compared as sets
    with sorted scores: near-ties may order differently), min(k, matching live rows)
    results per query, none outside the filter;
  * the same certificate-tier counts (the JAX engine's background heavy warm is awaited
    after each search, so its light -> heavy switch lands where the port's does);
  * the same transfer counts: one query upload each, and one download on a batch its
    first proof certifies (tier 0) or that runs no certificate.  An escalation on the
    port brings its tier-1 result down first and the escalation's result in counted
    copies of its own (an intended divergence, ROADMAP §C); JAX escalates on the device.
    The filter mask's upload is not counted, on either side.
Where a bf16 store's sweep escalates to the exact scan, the port's answer is held to the
float64 oracle over the stored rows instead of to JAX's (ROADMAP C15: JAX's scan ranks
bf16(q) with the written rows' norms; the port's scores the stored rows as its rescan
does); the tiers and transfers are still JAX's.
"""

import types
import uuid

import numpy as np
import pytest
import torch

from mlvectordb_tpu import filters as jax_filters
from mlvectordb_tpu.config import EngineConfig as JaxConfig
from mlvectordb_tpu.engine.query_processor import QueryProcessor as JaxQueryProcessor
from mlvectordb_tpu.interfaces.vector import VectorDTO as JaxDTO
from mlvectordb_tpu.ops import backend as jax_backend
from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO, filters
from mlvectordb_tpu_torch.engine import query_processor as qp_mod
from mlvectordb_tpu_torch.ops.fused_knn_t import SWEEP_TILE
from mlvectordb_tpu_torch.ops.settle import f32_band

from .test_torch_sweep import _clustered

D = 128
N = 2 * SWEEP_TILE      # the smallest capacity the sweep serves
B = 5


# ------------------------------------------------------------------ the mini-language

@pytest.fixture(params=["port", "jax"])
def matches_filter(request):
    return (filters if request.param == "port" else jax_filters).matches_filter


def test_equality_shorthand(matches_filter):
    assert matches_filter({"a": 1}, {"a": 1})
    assert not matches_filter({"a": 2}, {"a": 1})
    assert not matches_filter({}, {"a": 1})


def test_comparison_ops(matches_filter):
    m = {"n": 5}
    assert matches_filter(m, {"n": {"$gt": 4}})
    assert matches_filter(m, {"n": {"$gte": 5}})
    assert matches_filter(m, {"n": {"$lt": 6}})
    assert matches_filter(m, {"n": {"$lte": 5}})
    assert matches_filter(m, {"n": {"$ne": 4}})
    assert not matches_filter(m, {"n": {"$gt": 5}})
    assert matches_filter(m, {"n": {"$gt": 4, "$lt": 6}})  # implicit AND within field


def test_in_nin_exists(matches_filter):
    m = {"color": "red"}
    assert matches_filter(m, {"color": {"$in": ["red", "blue"]}})
    assert not matches_filter(m, {"color": {"$nin": ["red"]}})
    assert matches_filter(m, {"color": {"$exists": True}})
    assert matches_filter(m, {"size": {"$exists": False}})
    assert matches_filter(m, {"size": {"$ne": 1}})  # missing != 1
    assert matches_filter(m, {"size": {"$nin": [1]}})


def test_logical_combinators(matches_filter):
    m = {"a": 1, "b": 2}
    assert matches_filter(m, {"$and": [{"a": 1}, {"b": 2}]})
    assert matches_filter(m, {"$or": [{"a": 9}, {"b": 2}]})
    assert not matches_filter(m, {"$or": [{"a": 9}, {"b": 9}]})
    assert matches_filter(m, {"$not": {"a": 9}})
    assert not matches_filter(m, {"$not": {"a": 1}})


def test_dotted_paths(matches_filter):
    m = {"user": {"age": 30, "tags": {"vip": True}}}
    assert matches_filter(m, {"user.age": {"$gte": 18}})
    assert matches_filter(m, {"user.tags.vip": True})
    assert not matches_filter(m, {"user.missing": 1})


def test_type_mismatch_is_false_not_error(matches_filter):
    assert not matches_filter({"a": "str"}, {"a": {"$gt": 3}})


def test_empty_filter_matches_everything(matches_filter):
    assert matches_filter({}, None)
    assert matches_filter({"x": 1}, {})


def test_unknown_operator_raises(matches_filter):
    with pytest.raises(ValueError):
        matches_filter({"a": 1}, {"a": {"$regex": ".*"}})
    with pytest.raises(ValueError):
        matches_filter({"a": 1}, {"$xor": []})


def test_cache_key_and_operator_check_match_jax():
    specs = [{"b": 1, "a": {"$in": [2, 1]}}, {"$or": [{"x": None}, {"y.z": 3.5}]}, {}]
    for spec in specs:
        assert filters.filter_cache_key(spec) == jax_filters.filter_cache_key(spec)
        filters._validate_spec_ops(spec)
    for bad in ({"$xor": []}, {"a": {"$regex": "x"}}, {"$and": [{"$not": {"$nope": 1}}]}):
        for mod in (filters, jax_filters):
            with pytest.raises(ValueError):
                mod._validate_spec_ops(bad)


# ------------------------------------------------------------------ engines side by side

CONFIGS = {
    "row_f32": {},
    "row_bf16": {"dtype": "bfloat16"},
    "bf16_mirror": {"sweep_dtype": "bfloat16"},
    "int8_mirror": {"sweep_dtype": "int8"},
    "f32_mirror": {"sweep_dtype": "float32"},
    "same_dtype": {"dtype": "bfloat16", "sweep_dtype": "bfloat16"},
}


@pytest.fixture
def jax_on_tpu(monkeypatch):
    """The JAX engine picks its Pallas backends only on a TPU: tell it it runs on one
    (its kernels still run in interpret mode, pallas asks jax itself)."""
    monkeypatch.setattr(jax_backend, "jax",
                        types.SimpleNamespace(default_backend=lambda: "tpu"))


def _corpus(seed, n=N):
    """n gaussian rows, their uuids and metadata: "r" a random permutation of the rows
    (so {"r": {"$lt": c}} matches c rows spread over the store) and "p" = i % 2."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D), dtype=np.float32)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, n)]
    perm = rng.permutation(n)
    metas = [{"r": int(perm[i]), "p": i % 2} for i in range(n)]
    return rng, x, ids, metas


def _load_both(cfg, x, ids, metas, namespace="ns"):
    jqp = JaxQueryProcessor(config=JaxConfig(**cfg))
    tqp = QueryProcessor(EngineConfig(**cfg), device="cpu")
    for qp in (jqp, tqp):
        qp.bulk_load(x, namespace, ids=ids, metadatas=metas)
    return jqp, tqp


def _settle(jqp):
    """Wait for the JAX engine's background heavy warm to switch the mode."""
    import time

    deadline = time.time() + 300
    while time.time() < deadline:
        with jqp._cert_lock:
            if not jqp._heavy_warms:
                return
        time.sleep(0.05)
    raise AssertionError("the JAX heavy warm did not finish")


def _same_hits(jr, tr):
    assert [len(a) for a in jr] == [len(b) for b in tr]
    for a, b in zip(jr, tr):
        assert {r["id"] for r in a} == {r["id"] for r in b}
        np.testing.assert_allclose(sorted(r["score"] for r in b),
                                   sorted(r["score"] for r in a), rtol=1e-5, atol=1e-4)


def _f32_boundary(x, ids, metas, live):
    """_same_hits, but for ROADMAP C18: where JAX's set differs from the port's, the port's
    rows are the float64 oracle's over the matching live rows ``x`` (as stored), in its
    order, and each row
    JAX returned in their place lies within the f32 band (``settle.f32_band``) of the
    oracle's k-th distance: JAX's f32 top k, the port's float64 one."""
    x64 = x.astype(np.float64)
    row_of = {u: i for i, u in enumerate(ids)}

    def check(jr, tr, qs, metric, spec):
        assert [len(a) for a in jr] == [len(b) for b in tr]
        allowed = live & np.array([filters.matches_filter(m, spec) for m in metas])
        for q, a, b in zip(qs, jr, tr):
            if {r["id"] for r in a} == {r["id"] for r in b}:
                _same_hits([a], [b])
                continue
            q64 = q.astype(np.float64)
            if metric == "l2":
                d = ((x64 - q64) ** 2).sum(-1)
            elif metric == "ip":
                d = 1 - x64 @ q64
            else:
                d = 1 - x64 @ q64 / np.sqrt((x64 * x64).sum(-1) * (q64 @ q64))
            d[~allowed] = np.inf
            want = np.argsort(d, kind="stable")[:len(b)]
            assert [row_of[r["id"]] for r in b] == want.tolist()
            band = float(f32_band(metric, torch.tensor(float(q64 @ q64)),
                                  torch.tensor(float((x64[allowed] ** 2).sum(-1).max())),
                                  x.shape[1]))
            kth = d[want[-1]]
            for r in a:
                assert abs(d[row_of[r["id"]]] - kth) <= band or row_of[r["id"]] in want

    return check


def _stored_rows_exact(x, ids, metas, live):
    """The check of a bf16 store's scan (ROADMAP C15): the port's results are the float64
    oracle's over the stored rows (bf16(x)) with the f32 query, among the matching live
    rows: the returned rows' oracle distances are its smallest, their scores those
    distances (ties and scores within _same_hits' tolerance)."""
    rows = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    sq = (rows * rows).sum(1)
    row_of = {u: i for i, u in enumerate(ids)}

    def check(tr, qs, metric, spec):
        allowed = live & np.array([filters.matches_filter(m, spec) for m in metas])
        q = qs.astype(np.float64)
        dots, qn = q @ rows.T, (q * q).sum(1)[:, None]
        d = {"l2": lambda: sq[None] - 2.0 * dots + qn, "ip": lambda: 1.0 - dots,
             "cosine": lambda: 1.0 - dots / np.sqrt(np.maximum(sq[None] * qn, 1e-30))}[metric]()
        d[:, ~allowed] = np.inf
        for b, rs in enumerate(tr):
            want = np.sort(d[b])[: len(rs)]
            got = np.sort([d[b, row_of[r["id"]]] for r in rs])
            score = np.sort([1.0 - r["score"] if metric == "cosine" else r["score"] for r in rs])
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(score, want, rtol=1e-5, atol=1e-4)

    return check


def _filtered_both(jqp, tqp, qs, k, metric, spec, namespace="ns", scan_exact=None,
                   boundary=None):
    """One filtered batch through both engines; asserts results, tiers and transfers
    equal (see the module docstring; ``scan_exact``: the check of a batch the port's
    exact scan served in place of JAX's results; ``boundary``: ``_f32_boundary``'s check
    in place of ``_same_hits``).  Returns (port results, the tier names it added)."""
    jx, tx = dict(jqp.transfer_counts), dict(tqp.transfer_counts)
    t0 = tqp.cert_tier_counts(namespace)
    jr = jqp.find_similar_batch([JaxDTO(v) for v in qs], k, namespace, metric, filter=spec)
    tr = tqp.find_similar_batch([VectorDTO(v) for v in qs], k, namespace, metric,
                                filter=spec)
    _settle(jqp)
    if tqp.config.sweep_dtype is None:
        # ROADMAP C20: the port's row-major path records the tier it proved each batch
        # at; JAX's proves none and records none
        assert jqp.cert_tier_counts(namespace) == {}
    else:
        assert tqp.cert_tier_counts(namespace) == jqp.cert_tier_counts(namespace)
    tier = [t for t, c in tqp.cert_tier_counts(namespace).items() if c != t0.get(t, 0)]
    if scan_exact is not None and tier == ["exact_scan"]:
        assert [len(a) for a in jr] == [len(b) for b in tr]
        scan_exact(tr, qs, metric, spec)
    elif boundary is not None:
        boundary(jr, tr, qs, metric, spec)
    else:
        _same_hits(jr, tr)
    assert all(filters.matches_filter(r["metadata"], spec) for rs in tr for r in rs)
    jd = {d: jqp.transfer_counts[d] - jx[d] for d in jx}
    td = {d: tqp.transfer_counts[d] - tx[d] for d in tx}
    assert jd == {"h2d": 1, "d2h": 1} and td["h2d"] == 1
    if tier in ([], ["fast"], ["light_fast"]):
        assert td["d2h"] == 1
    else:
        assert td["d2h"] >= 2, (tier, td)
    return tr, tier


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_filtered_search_matches_jax(jax_on_tpu, config, metric):
    """Filters matching 0, 3, k - 1, k and half the rows, at k = 10 and 100, before and
    after 300 deletes (two of them in the 3-row filter) and after a compaction."""
    rng, x, ids, metas = _corpus(list(CONFIGS).index(config) * 3 + len(metric))
    jqp, tqp = _load_both(CONFIGS[config], x, ids, metas)
    ns = tqp.storage.namespace("ns")
    assert ns.capacity == N and ns.meta_columns is not None
    qs = rng.standard_normal((B, D), dtype=np.float32)
    r_of = np.array([m["r"] for m in metas])
    live = np.ones(N, bool)
    scan_exact = (_stored_rows_exact(x, ids, metas, live) if config == "same_dtype"
                  else None)
    tiers = set()
    for stage in ("fresh", "deleted", "compacted"):
        if stage == "deleted":
            gone = np.concatenate([np.flatnonzero(r_of < 3)[:2],
                                   rng.choice(np.flatnonzero(r_of >= 100), 298, False)])
            live[gone] = False
            for qp in (jqp, tqp):
                qp.delete([ids[i] for i in gone], "ns")
            assert ns.device_state().live_count < ns.device_state().high_water
        elif stage == "compacted":
            for qp in (jqp, tqp):
                with qp._write_lock:
                    qp.storage.namespace("ns").compact()
            assert ns.device_state().live_count == ns.device_state().high_water
        for k in (10, 100):
            for spec in ({"r": {"$lt": 0}}, {"r": {"$lt": 3}}, {"r": {"$lt": k - 1}},
                         {"r": {"$lt": k}}, {"p": 0}):
                match = live & np.array([filters.matches_filter(m, spec) for m in metas])
                tr, tier = _filtered_both(jqp, tqp, qs, k, metric, spec, scan_exact=scan_exact)
                tiers.update(tier)
                assert [len(r) for r in tr] == [min(k, int(match.sum()))] * B, (stage, spec)
    if CONFIGS[config].get("sweep_dtype"):
        assert tiers and tiers <= {"fast", "light_fast", "widened", "light_widened",
                                   "exact_scan", "light_exact_scan", "disengaged"}
    else:
        # ROADMAP C20: every row-major batch proven at tier 0 (JAX's records none)
        assert tiers == {"fast"}


def test_filtered_range_and_similarity_search_match_jax(jax_on_tpu):
    rng, x, ids, metas = _corpus(5)
    jqp, tqp = _load_both({"sweep_dtype": "bfloat16"}, x, ids, metas)
    qv = rng.standard_normal(D).astype(np.float32)
    spec = {"p": 1}
    even = np.array([m["p"] == 1 for m in metas])
    d64 = np.where(even, ((qv.astype(np.float64) - x) ** 2).sum(-1), np.inf)
    radius = float(np.sort(d64)[29:31].mean())
    cos = (x.astype(np.float64) @ qv) / (np.linalg.norm(x, axis=1) * np.linalg.norm(qv))
    threshold = float(np.sort(np.where(even, cos, -np.inf))[::-1][29:31].mean())
    jr = jqp.range_search(JaxDTO(qv), radius, "ns", filter=spec, limit=100)
    tr = tqp.range_search(VectorDTO(qv), radius, "ns", filter=spec, limit=100)
    js = jqp.similarity_search(JaxDTO(qv), threshold, "ns", filter=spec, limit=100)
    ts = tqp.similarity_search(VectorDTO(qv), threshold, "ns", filter=spec, limit=100)
    _settle(jqp)
    for a, b in ((jr, tr), (js, ts)):
        assert len(b) == 30 and all(r["metadata"]["p"] == 1 for r in b)
        assert [r["id"] for r in b] == [r["id"] for r in a]
        np.testing.assert_allclose([r["score"] for r in b], [r["score"] for r in a],
                                   rtol=1e-5, atol=1e-4)
    assert tqp.cert_tier_counts("ns") == jqp.cert_tier_counts("ns")


# ------------------------------------------------------------------ tests/test_engine.py's
# hybrid cases, side by side (small capacities: the engines' scan and row-major paths)

SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_metadata_filtered_hybrid_search_matches_jax(jax_on_tpu, use_pallas):
    cfg = dict(SMALL, use_pallas=use_pallas)
    jqp, tqp = JaxQueryProcessor(config=JaxConfig(**cfg)), QueryProcessor(
        EngineConfig(**cfg), device="cpu")
    rng = np.random.default_rng(42)
    vals = [rng.standard_normal(8).astype(np.float32) for _ in range(30)]
    red, blue = [], []
    for i, v in enumerate(vals):
        color = "red" if i % 2 == 0 else "blue"
        vid = uuid.UUID(int=i + 1)
        jqp.insert(JaxDTO(v, {"color": color, "i": i}, id=vid), "ns")
        tqp.insert(VectorDTO(v, {"color": color, "i": i}, id=vid), "ns")
        (red if color == "red" else blue).append(vid)
    q = rng.standard_normal(8).astype(np.float32)
    jr = jqp.find_similar(JaxDTO(q), top_k=30, namespace="ns", filter={"color": "red"})
    tr = tqp.find_similar(VectorDTO(q), top_k=30, namespace="ns", filter={"color": "red"})
    assert len(tr) == 15 and {r["id"] for r in tr} == set(red)
    _same_hits([jr], [tr])
    jr = jqp.find_similar(JaxDTO(q), top_k=5, namespace="ns", filter={"i": {"$lt": 4}})
    tr = tqp.find_similar(VectorDTO(q), top_k=5, namespace="ns", filter={"i": {"$lt": 4}})
    assert len(tr) == 4 and {r["id"] for r in tr} == {uuid.UUID(int=i + 1) for i in range(4)}
    _same_hits([jr], [tr])
    # query_by_metadata: JAX's dict shape with score 0.0, in the same order
    jm = jqp.query_by_metadata({"color": "blue"}, "ns", limit=10)
    tm = tqp.query_by_metadata({"color": "blue"}, "ns", limit=10)
    assert [r["id"] for r in tm] == [r["id"] for r in jm] == blue[:10]
    assert all(r["score"] == 0.0 and set(r) == {"id", "values", "metadata", "score"}
               for r in tm)
    assert tqp.query_by_metadata({"color": "red"}, "missing") == []
    assert tqp.storage.query_by_metadata({"i": 3}, "ns")[0].id == uuid.UUID(int=4)
    with pytest.raises(ValueError):
        tqp.query_by_metadata({"i": {"$regex": "x"}}, "ns")


def test_bulk_load_is_filterable_like_jax(jax_on_tpu):
    cfg = dict(SMALL, use_pallas=False)
    rng = np.random.default_rng(42)
    vals = rng.standard_normal((300, 8)).astype(np.float32)
    metas = [{"i": i} for i in range(300)]
    jqp, tqp = JaxQueryProcessor(config=JaxConfig(**cfg)), QueryProcessor(
        EngineConfig(**cfg), device="cpu")
    ids = jqp.bulk_load(vals, "ns", metadatas=metas)
    tqp.bulk_load(vals, "ns", ids=ids, metadatas=metas)
    jr = jqp.find_similar(JaxDTO(vals[10]), top_k=5, namespace="ns", filter={"i": {"$lt": 5}})
    tr = tqp.find_similar(VectorDTO(vals[10]), top_k=5, namespace="ns",
                          filter={"i": {"$lt": 5}})
    assert all(r["metadata"]["i"] < 5 for r in tr) and len(tr) == 5
    _same_hits([jr], [tr])
    # an explicit-id overwrite moves the row in and out of the filter
    for qp, dto in ((jqp, JaxDTO), (tqp, VectorDTO)):
        qp.upsert_many([dto(vals[200], {"i": 1}, id=ids[200])], "ns")
        qp.upsert_many([dto(vals[1], {"i": 99}, id=ids[1])], "ns")
    jr = jqp.find_similar(JaxDTO(vals[10]), top_k=5, namespace="ns", filter={"i": {"$lt": 5}})
    tr = tqp.find_similar(VectorDTO(vals[10]), top_k=5, namespace="ns",
                          filter={"i": {"$lt": 5}})
    assert ids[200] in {r["id"] for r in tr} and ids[1] not in {r["id"] for r in tr}
    _same_hits([jr], [tr])


def test_filter_prep_scoped_inside_snapshot():
    """tests/test_engine.py's case on the port: the filtered search's prep is nested
    under ("filter", key) INSIDE the snapshot's own prep dict; a write publishes a fresh
    dict without it."""
    tqp = QueryProcessor(EngineConfig(sweep_dtype="bfloat16"), device="cpu")
    _, x, ids, metas = _corpus(0)
    tqp.bulk_load(x, "f", ids=ids, metadatas=metas)
    ns = tqp.storage.namespace("f")
    spec = {"p": 0}
    q = VectorDTO(x[0])
    r1 = tqp.find_similar(q, top_k=5, namespace="f", metric="euclidean", filter=spec)
    assert r1[0]["id"] == ids[0] and all(v["metadata"]["p"] == 0 for v in r1)
    state1 = ns.device_state()
    key = ("filter", filters.filter_cache_key(spec))
    assert list(state1.prep_cache) == [key]          # the filter's scope, nothing else
    assert any(isinstance(k2, tuple) and k2[2] is True for k2 in state1.prep_cache[key])
    tqp.upsert_many([VectorDTO(x[1] + 1.0, {"p": 0})], "f")
    state2 = ns.device_state()
    assert state2.prep_cache is not state1.prep_cache and key not in state2.prep_cache
    r2 = tqp.find_similar(q, top_k=5, namespace="f", metric="euclidean", filter=spec)
    assert [r["id"] for r in r2] == [r["id"] for r in r1]


def test_filter_scopes_are_bounded():
    tqp = QueryProcessor(EngineConfig(sweep_dtype="bfloat16"), device="cpu")
    _, x, ids, metas = _corpus(1)
    tqp.bulk_load(x, "f", ids=ids, metadatas=metas)
    state = tqp.storage.namespace("f").device_state()
    q = [VectorDTO(x[0])]
    for c in range(qp_mod._FILTER_SCOPES + 3):
        res = tqp.find_similar_batch(q, 3, "f", filter={"r": {"$lt": 500 + c}})
        assert len(res[0]) == 3
    assert len(state.prep_cache) == qp_mod._FILTER_SCOPES


# ------------------------------------------------------------------ prep scoping (one
# snapshot, filtered and unfiltered masked traffic)

def _fresh_result(cfg, x, ids, metas, gone, qs, k, spec):
    tqp = QueryProcessor(EngineConfig(**cfg), device="cpu")
    tqp.bulk_load(x, "ns", ids=ids, metadatas=metas)
    tqp.delete(gone, "ns")
    return tqp.find_similar_batch([VectorDTO(v) for v in qs], k, "ns", "l2", filter=spec)


def _identical(a, b):
    assert [[r["id"] for r in rs] for rs in a] == [[r["id"] for r in rs] for rs in b]
    assert [[r["score"] for r in rs] for rs in a] == [[r["score"] for r in rs] for rs in b]


@pytest.mark.parametrize("config", ["bf16_mirror", "int8_mirror", "same_dtype"])
def test_filtered_and_unfiltered_masked_searches_never_share_prep(jax_on_tpu, monkeypatch,
                                                                  config):
    """In one tombstoned snapshot an unfiltered (masked) search and a filtered one of 70
    queries (the 512 bucket: padded rows served from the zero-query column), in turns and
    at k = 10 and 100, each give JAX's answer (up to the f32 boundary of ROADMAP C18:
    ``_f32_boundary``) and the answer of a fresh processor that served only that call;
    the snapshot's own prep and zero-query columns and the
    filter's are distinct objects built from different liveness; the filter's mask
    reaches the device once per snapshot."""
    cfg = CONFIGS[config]
    rng, x, ids, metas = _corpus(11)
    jqp, tqp = _load_both(cfg, x, ids, metas)
    gone = [ids[i] for i in rng.choice(N, 64, replace=False)]
    for qp in (jqp, tqp):
        qp.delete(gone, "ns")
    ns = tqp.storage.namespace("ns")
    state = ns.device_state()
    spec = {"p": 0}
    qs = rng.standard_normal((70, D), dtype=np.float32)
    fresh = {(k, f is None): _fresh_result(cfg, x, ids, metas, gone, qs, k, f)
             for k in (10, 100) for f in (None, spec)}
    uploads = []
    real_upload = qp_mod._upload_mask
    monkeypatch.setattr(qp_mod, "_upload_mask",
                        lambda m, d: uploads.append(m.shape) or real_upload(m, d))
    live = np.ones(N, bool)
    live[[ids.index(g) for g in gone]] = False
    stored = torch.from_numpy(x).to(torch.bfloat16).float().numpy() if cfg.get(
        "dtype") == "bfloat16" else x
    boundary = _f32_boundary(stored, ids, metas, live)
    for rnd in range(2):
        for k in (10, 100):
            for f in (None, spec):
                jr = jqp.find_similar_batch([JaxDTO(v) for v in qs + rnd], k, "ns", "l2",
                                            filter=f)
                tr = tqp.find_similar_batch([VectorDTO(v) for v in qs + rnd], k, "ns",
                                            "l2", filter=f)
                _settle(jqp)
                boundary(jr, tr, qs + rnd, "l2", f)
                if rnd == 0:
                    _identical(tr, fresh[(k, f is None)])
    assert tqp.cert_tier_counts("ns") == jqp.cert_tier_counts("ns")
    assert ns.device_state() is state and uploads == [(N,)]
    scope = state.prep_cache[("filter", filters.filter_cache_key(spec))]
    own = {k2: v for k2, v in state.prep_cache.items() if k2[0] != "filter"}
    assert own and set(own) == set(scope) - {"valid"}
    for k2 in own:
        assert own[k2] is not scope[k2]
        assert not torch.equal(own[k2]["bias_row"], scope[k2]["bias_row"])
        zo, zs = own[k2]["zero_query"], scope[k2]["zero_query"]
        assert zo and zo.keys() == zs.keys() and zo is not zs
        for z in zo:       # the padded rows' window mins over different liveness
            assert not torch.equal(zo[z][0], zs[z][0]) if zo[z][0] is not None else True
    mask = torch.from_numpy(np.array([m["p"] == 0 for m in metas]))
    assert torch.equal(scope["valid"], state.valid & mask)
    assert tqp.transfer_counts["h2d"] == 8
    # the zero-query columns lie inside each prep dict, so no other key holds one
    assert not any(k2 == "zero_query" for k2 in list(state.prep_cache) + list(scope))


def test_filtered_heavy_flip_files_prep_in_the_filter_scope_only(jax_on_tpu):
    """The port's form of tests/test_engine.py's test_heavy_warm_uses_filter_scoped_prep:
    a clustered namespace whose light proof fails under a filter switches its masked
    variant to the heavy program; the snapshot's own prep dict then holds nothing but the
    filter's scope, which holds the light and the heavy prep.  Tiers equal JAX's, whose
    heavy warm runs in the background and is awaited, and so do results, up to the f32
    boundary of ROADMAP C18 (``_f32_boundary``: the clusters' near-ties)."""
    rng, x, q = _clustered(81, 3 * SWEEP_TILE, 8, 8, 0.05, 1e-3)
    n = x.shape[0]
    ids = [uuid.UUID(int=i + 1) for i in range(n)]
    metas = [{"p": i % 2} for i in range(n)]
    jqp, tqp = _load_both({"sweep_dtype": "bfloat16"}, x, ids, metas, "c")
    spec = {"p": 1}
    state = tqp.storage.namespace("c").device_state()
    boundary = _f32_boundary(x, ids, metas, np.ones(n, bool))
    for rnd in range(2):
        _filtered_both(jqp, tqp, q + np.float32(rnd * 1e-4), 10, "l2", spec, "c",
                       boundary=boundary)
    assert tqp._cert_mode == {("c", "l2", True): "heavy"}
    assert jqp._cert_mode == tqp._cert_mode
    counts = tqp.cert_tier_counts("c")
    assert counts["light_exact_scan"] == 1 and sum(counts.values()) == 2
    assert all(k2[0] == "filter" for k2 in state.prep_cache)
    (scope,) = state.prep_cache.values()
    lights = {k2[4] for k2 in scope if isinstance(k2, tuple)}
    assert lights == {True, False} and all(k2[2] is True for k2 in scope
                                           if isinstance(k2, tuple))
    # unfiltered traffic runs its own (unmasked) variant, light until its own proof
    # fails, with prep of its own beside the filter's scope
    _, tier = _filtered_both(jqp, tqp, q, 10, "l2", None, "c", boundary=boundary)
    assert tier == ["light_exact_scan"] and jqp._cert_mode == tqp._cert_mode == {
        ("c", "l2", True): "heavy", ("c", "l2", False): "heavy"}
    own = [k2 for k2 in state.prep_cache if k2[0] != "filter"]
    assert own and all(k2[2] is False and k2[4] is True for k2 in own)


# ------------------------------------------------------------------ the RCU retry

def test_rcu_retry_when_a_write_lands_during_the_mask_build(jax_on_tpu):
    """A write published while the filter mask is built moves the version: the search
    re-snapshots and answers from the new snapshot (it sees the written row), as the JAX
    engine does under the same interleaving."""
    _, x, ids, metas = _corpus(3, n=2000)
    out = []
    for qp, dto in ((JaxQueryProcessor(config=JaxConfig()), JaxDTO),
                    (QueryProcessor(EngineConfig(), device="cpu"), VectorDTO)):
        qp.bulk_load(x, "ns", ids=ids, metadatas=metas)
        real = qp._filter_masks.mask_for
        q = np.full(D, 0.5, np.float32)
        calls = []

        def mask_for(ns, spec, qp=qp, real=real, q=q, calls=calls, dto=dto):
            calls.append(ns.version)
            if len(calls) == 1:  # a writer lands mid-build: a new row equal to the query
                qp.upsert_many([dto(q, {"p": 0}, id=uuid.UUID(int=7))], "ns")
            return real(ns, spec)

        qp._filter_masks.mask_for = mask_for
        res = qp.find_similar(dto(q), 3, "ns", "l2", filter={"p": 0})
        assert len(calls) == 2 and calls[1] == calls[0] + 1
        assert res[0]["id"] == uuid.UUID(int=7) and res[0]["score"] < 1e-4
        out.append(res)
    _same_hits([out[0]], [out[1]])


def test_rcu_retry_bounds_and_last_attempt_under_the_lock():
    _, x, ids, metas = _corpus(4, n=1000)
    tqp = QueryProcessor(EngineConfig(), device="cpu")
    tqp.bulk_load(x, "ns", ids=ids, metadatas=metas)
    want = tqp.find_similar_batch([VectorDTO(x[3])], 4, "ns", filter={"p": 1})
    tqp._result_cache.clear()
    real = tqp._filter_masks.mask_for
    locked = []

    def moving(ns_, spec):
        locked.append(ns_._lock._recursion_count())
        if len(locked) < 6:
            ns_.version += 1          # the version moves during every build but the last
        return real(ns_, spec)

    tqp._filter_masks.mask_for = moving
    got = tqp.find_similar_batch([VectorDTO(x[3])], 4, "ns", filter={"p": 1})
    assert locked == [1] * 5 + [2]     # the mask under the lock; the last attempt in it
    _identical(got, want)

    def shrunk(ns_, spec):          # a capacity change between snapshot and mask
        locked.append(None)
        m = real(ns_, spec)
        return m[:-1] if len(locked) == 1 else m

    locked.clear()
    tqp._result_cache.clear()
    tqp._filter_masks.mask_for = shrunk
    _identical(tqp.find_similar_batch([VectorDTO(x[3])], 4, "ns", filter={"p": 1}), want)
    assert len(locked) == 2

    def failing(ns_, spec):         # only "deleted" errors are retried
        locked.append(None)
        raise RuntimeError("mask evaluation failed")

    locked.clear()
    tqp._filter_masks.mask_for = failing
    with pytest.raises(RuntimeError, match="mask evaluation failed"):
        tqp.find_similar_batch([VectorDTO(x[5])], 4, "ns", filter={"p": 1})
    assert len(locked) == 1


def test_result_cache_is_keyed_by_the_filter():
    _, x, ids, metas = _corpus(6, n=500)
    tqp = QueryProcessor(EngineConfig(), device="cpu")
    tqp.bulk_load(x, "ns", ids=ids, metadatas=metas)
    q = [VectorDTO(x[0])]
    a = tqp.find_similar_batch(q, 5, "ns", filter={"p": 0})
    b = tqp.find_similar_batch(q, 5, "ns", filter={"p": 1})
    c = tqp.find_similar_batch(q, 5, "ns")
    assert tqp._result_cache_hits == 0
    assert {r["metadata"]["p"] for r in a[0]} == {0} and {r["metadata"]["p"] for r in b[0]} == {1}
    assert tqp.find_similar_batch(q, 5, "ns", filter={"p": 1}) == b
    assert tqp.find_similar_batch(q, 5, "ns") == c and tqp._result_cache_hits == 2
    assert tqp.find_similar_batch(q, 5, "ns", filter={}) == c      # an empty filter is none
    assert tqp._result_cache_hits == 3


# ------------------------------------------------------------------ ROADMAP C3, C17


def _c3_rows(n=32768):
    """C2's construction (tests/test_torch_row_live.py): row A (100) rounds to the
    all-ones query, distance 0 over the stored rows, but its written f32 norm is larger by
    0.94; 16 decoys sit at 0.25-0.38 and 24 more at 0.71 (l2; for cosine their direction
    is as close: A's written value is 0.0038 off the query's, the 16 decoys 0.001-0.0015);
    the other rows are far."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((n, D)) + 8).astype(np.float32)
    x[100] = np.float32(1 + 2.0 ** -8 - 2.0 ** -12)
    for i, r in enumerate(range(1000, 1000 + 40 * 64, 64)):
        x[r] = 1.0
        x[r, i % D] += np.float32(0.5 + i / 128 if i < 16 else 0.84375)
    return x, np.ones(D, np.float32), 100


def _c3_searches(x, q, metric, k=10):
    """A filter holding every row sends the row-major search through B5
    (``use_pallas=True``); ``use_pallas=False`` is the scan.  Per path and stage (before
    and after a compaction): the answers of the JAX engine written x, of its twin written
    bf16(x) and of the port."""
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    metas = [{"all": True} for _ in range(len(x))]
    spec = {"all": True}
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    out = {}
    for use_pallas in (True, False):
        cfg = {"dtype": "bfloat16", "use_pallas": use_pallas}
        jqp, tqp = _load_both(cfg, x, ids, metas)
        twin = JaxQueryProcessor(config=JaxConfig(**cfg))
        twin.bulk_load(xb, "ns", ids=ids, metadatas=metas)
        for stage in ("written norms", "compacted"):
            if stage == "compacted":
                for qp in (jqp, twin, tqp):
                    with qp._write_lock:
                        qp.storage.namespace("ns").compact()
            out[use_pallas, stage] = (
                jqp.find_similar_batch([JaxDTO(q)], k, "ns", metric, filter=spec)[0],
                twin.find_similar_batch([JaxDTO(q)], k, "ns", metric, filter=spec)[0],
                tqp.find_similar_batch([VectorDTO(q)], k, "ns", metric, filter=spec)[0])
    return ids, out


def _same_answer(a, b):
    assert [r["id"] for r in a] == [r["id"] for r in b]
    np.testing.assert_allclose([r["score"] for r in a], [r["score"] for r in b], rtol=1e-5,
                               atol=1e-4)


def _assert_c3(x, q, a_row, metric, separates):
    """The port returns A first at distance 0 on both paths before and after a
    compaction, as its JAX twin does.  The JAX engine written x does too, save on the
    scan before a compaction (``separates``): it ranks with the written norms and leaves A
    out of its top 10."""
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    qd = q.astype(np.float64)
    dist = (((xb - qd) ** 2).sum(1) if metric == "l2"
            else 1 - xb @ qd / np.sqrt((xb * xb).sum(1) * (qd * qd).sum()) if metric == "cosine"
            else 1 - xb @ qd)
    want = set(np.argsort(dist, kind="stable")[:10].tolist())
    assert np.sort(dist)[10] > np.sort(dist)[9]
    ids, out = _c3_searches(x, q, metric)
    best = {"l2": 0.0, "cosine": 1.0}.get(metric)
    for (use_pallas, stage), (jr, wr, tr) in out.items():
        key = (use_pallas, stage)
        assert {r["id"].int - 1 for r in tr} == want, key
        if a_row in want:
            assert tr[0]["id"] == ids[a_row] and tr[0]["score"] == best, key
        _same_answer(tr, wr)
        found = ids[a_row] in {r["id"] for r in jr}
        if separates and not use_pallas and stage == "written norms":
            assert not found, key                        # the reference's wrong set
        else:
            _same_answer(tr, jr)


def test_c3_bf16_store_masked_row_major_and_scan_match_jax(jax_on_tpu):
    """ROADMAP C3 and C17: a bf16 store before its first compaction, l2.  The JAX store
    ranks with the written f32 rows' norms (B5's l2 bias row and the exact scan) while its
    rescan scores the stored bf16 rows; the port's store holds the stored rows' norms.  On
    C2's construction B5's selection takes A's window in both packages and the rescan
    puts A first at distance 0; the scan ranks with the norms alone, so before a
    compaction the JAX engine written x leaves A out of its top 10, where the port and
    the JAX twin written bf16(x) return A first.  After a compaction (norms of the stored
    rows) all three agree."""
    x, q, a_row = _c3_rows()
    _assert_c3(x, q, a_row, "l2", separates=True)


def test_c3_bf16_store_cosine_row_major_and_scan_are_exact(jax_on_tpu):
    """C3's construction under cosine, which ranks with the norms on the scan: before a
    compaction the JAX engine written x leaves A out there, while the port and the twin
    return A first at similarity 1.  (ip ranks with no norm on the row-major path, so the
    written norms cannot separate the packages there.)"""
    x, q, a_row = _c3_rows()
    _assert_c3(x, q, a_row, "cosine", separates=True)
