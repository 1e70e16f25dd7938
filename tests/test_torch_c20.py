"""ROADMAP C20: the row-major path proves each query's set, on the CPU.

The default ``EngineConfig`` (no sweep mirror) serves exact k-NN through kernels B4/B5,
a selection of s = min(2k, k+16) windows by their phase-1 minimum, and a rescan.  The
JAX package returns that selection with no proof; where phase 1's f32 error exceeds the
gaps between the nearest rows, the true neighbours sit in windows it left out.  The port
proves each query (``ops/fused_knn.py``: the smallest phase-1 minimum left out, less a
bound on phase 1's error, above the settled k-th) and escalates a failed proof as the
certified sweep does: the failing queries selected again at 8x the width, then the scan.

The construction: 16,384 x 128 rows N(0, 0.1^2), 64 of them overwritten with near
duplicates c + N(0, 1e-4^2) of one centre c ~ N(0, 10^2), and queries c + N(0, 1).  The
f32 error of the l2 expansion grows with |q|^2 + |x|^2, so near duplicates of a large
centre put more windows inside phase 1's error than the 16 spare windows hold.  Every
case holds the port's ids, set and order, to the float64 oracle's and records the JAX
engine's (told it runs on a TPU, its Pallas kernels in interpret mode) misses beside
them: the l2, ip and cosine metrics, an f32 and a bf16 store, the fast kernel, the
masked one after deletes and under a filter, a (1, 2) mesh of CPU shards, range search;
the tier each search was served at; gaussian rows at tier 0 in one copy each way; and
``certify_exact=False``, which keeps the unproven selection, as JAX does.
"""

import types
import uuid

import ml_dtypes
import numpy as np
import pytest
import torch

from mlvectordb_tpu.config import EngineConfig as JaxConfig
from mlvectordb_tpu.engine.query_processor import QueryProcessor as JaxQueryProcessor
from mlvectordb_tpu.interfaces.vector import VectorDTO as JaxDTO
from mlvectordb_tpu.ops import backend as jax_backend
from mlvectordb_tpu.ops import pallas_knn as JF
from mlvectordb_tpu.parallel import ShardingManager as JShardingManager
from mlvectordb_tpu.parallel import build_mesh as jbuild_mesh
from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.ops import fused_knn as F
from mlvectordb_tpu_torch.ops.fused_knn_t import fetch
from mlvectordb_tpu_torch.parallel import ShardingManager, build_mesh

N, D, B, K = 16384, 128, 8, 10
METRICS = ("l2", "ip", "cosine")


def _construction(n, seed, n_queries=B, near=B):
    """Rows N(0, 0.1^2) with 64 near duplicates of a centre c ~ N(0, 10^2), and queries:
    the first ``near`` c + N(0, 1), the rest N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.1, (n, D)).astype(np.float32)
    dup = rng.choice(n, 64, replace=False)
    c = rng.normal(0, 10, D)
    x[dup] = (c + rng.normal(0, 1e-4, (64, D))).astype(np.float32)
    q = rng.normal(0, 0.1, (n_queries, D)).astype(np.float32)
    q[:near] = (c + rng.normal(0, 1, (near, D))).astype(np.float32)
    return x, q, dup


def _oracle(rows, q, metric, live, k=K):
    """The float64 oracle's k nearest live rows, in order (ties by row)."""
    r, qq = rows.astype(np.float64), q.astype(np.float64)
    if metric == "l2":
        d = ((qq[:, None] - r[None]) ** 2).sum(-1)
    elif metric == "ip":
        d = 1.0 - qq @ r.T
    else:
        nn = (qq ** 2).sum(1)[:, None] * (r ** 2).sum(1)[None]
        d = 1.0 - (qq @ r.T) / np.sqrt(np.maximum(nn, 1e-30))
    d[:, ~live] = np.inf
    return np.argsort(d, axis=1, kind="stable")[:, :k], d


def _misses(want, got):
    return [len(set(w) - set(g)) for w, g in zip(want.tolist(), got.tolist())]


X, Q, DUP = _construction(N, 0)
IDS = [uuid.UUID(int=i + 1) for i in range(N)]
GONE = np.array([i for i in range(0, N, 7) if i not in set(DUP.tolist())])


@pytest.fixture(scope="module")
def engines():
    """The construction in the port's engine and the JAX engine, the default config with
    f32 and with bf16 rows; every row carries {"p": i % 3}."""
    out = {}
    metas = [{"p": i % 3} for i in range(N)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backend, "jax", types.SimpleNamespace(default_backend=lambda: "tpu"))
        for dtype in ("float32", "bfloat16"):
            tqp = QueryProcessor(EngineConfig(dtype=dtype), device="cpu")
            jqp = JaxQueryProcessor(config=JaxConfig(dtype=dtype))
            for qp in (tqp, jqp):
                qp.bulk_load(X, "ns", ids=IDS, metadatas=metas)
            out[dtype] = (tqp, jqp)
        yield out, mp


def _ids(results):
    return np.array([[r["id"].int - 1 for r in res] for res in results])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("variant", ["fast", "deleted", "filter"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_c20_engine_returns_the_oracles_set_and_order(engines, dtype, variant, metric):
    """The default engine (B4 over the live prefix, B5 after deletes or under a filter):
    the float64 oracle's ids in its order, over the stored rows (a bf16 store's rounded
    rows, scored with the f32 query).  At 16,384 rows and the 8-query bucket no tier 1
    exists (8 x 208 windows x 32 rows > the capacity), so a failed proof goes to the scan:
    each batch at tier 2, in its one copy down and the scan's one more.  JAX's engine
    returns the unproven selection and misses rows of the oracle's."""
    (qps, _) = engines
    tqp, jqp = qps[dtype]
    if variant == "deleted" and tqp.get_namespace_count("ns") == N:
        for qp in (tqp, jqp):
            qp.delete([IDS[i] for i in GONE], "ns")
    live = np.ones(N, bool)
    if variant != "fast":
        live[GONE] = False
    flt = {"p": 0} if variant == "filter" else None
    if flt:
        live &= np.arange(N) % 3 == 0
    rows = X if dtype == "float32" else X.astype(ml_dtypes.bfloat16).astype(np.float32)
    want, _ = _oracle(rows, Q, metric, live)
    tiers, xfer = tqp.cert_tier_counts("ns"), dict(tqp.transfer_counts)
    settles = tqp.settle_copies
    got = _ids(tqp.find_similar_batch([VectorDTO(v) for v in Q], K, "ns", metric, filter=flt))
    jgot = _ids(jqp.find_similar_batch([JaxDTO(v) for v in Q], K, "ns", metric, filter=flt))
    assert (got == want).all(), (_misses(want, got), _misses(want, jgot))
    assert sum(_misses(want, jgot)) > 0, "the JAX engine's unproven selection"
    served = {t: c - tiers.get(t, 0) for t, c in tqp.cert_tier_counts("ns").items()
              if c != tiers.get(t, 0)}
    assert jqp.cert_tier_counts("ns") == {}          # JAX records no row-major tier
    # under the filter 21 near duplicates remain, inside the 32 windows: proven at tier 0
    # (the float64 settle flags the batch: one more copy, counted apart)
    assert served == ({"fast": 1} if flt else {"exact_scan": 1})
    assert (tqp.transfer_counts["h2d"] - xfer["h2d"],
            tqp.transfer_counts["d2h"] - xfer["d2h"] - (tqp.settle_copies - settles)) == (
        1, 1 if flt else 2)


def test_c20_range_search_returns_the_oracles_hits(engines):
    """range_search runs the same proven search (k = limit): within a radius that holds
    the 64 near duplicates and no other row, the oracle's hits."""
    (qps, _) = engines
    tqp, jqp = qps["float32"]
    want, d = _oracle(X, Q[:1], "l2", np.ones(N, bool), k=N)
    radius = 1000.0
    hits = set(want[0][d[0][want[0]] <= radius].tolist())
    assert hits == set(DUP.tolist())
    got = tqp.range_search(VectorDTO(Q[0]), radius, "ns", limit=100)
    jgot = jqp.range_search(JaxDTO(Q[0]), radius, "ns", limit=100)
    assert {r["id"].int - 1 for r in got} == hits
    assert [r["id"].int - 1 for r in got] == [i for i in want[0] if i in hits]
    assert len(jgot) == len({r["id"] for r in jgot})


@pytest.mark.parametrize("metric", METRICS)
def test_c20_mesh_shards_prove_each_shard(metric):
    """A (1, 2) mesh of CPU shards: each shard runs B5 with its own proof, escalates
    within the shard, and the shards' exact lists merge exactly.  JAX's sharded search
    merges the shards' unproven selections."""
    valid = np.ones(N, bool)
    sq = (X.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    sm = ShardingManager(build_mesh(1, 2, devices=[torch.device("cpu")] * 2))
    shards = sm.place_database(*(torch.from_numpy(a) for a in (X, valid, sq)))
    out = sm.sharded_knn(torch.from_numpy(Q), shards, k=K, metric=metric, n_live=B,
                         defer=True)
    copies = []
    d, i, tier = out.finish(fetch(*out.parts()),
                            lambda *t: copies.append(len(t)) or fetch(*t))
    want, _ = _oracle(X, Q, metric, valid)
    # both shards fail (32 near duplicates each, 20 windows at k = 10) and, with no tier
    # 1 at 8,192 rows a shard, each scans its rows in one copy of (dist, idx, key)
    assert tier == 2 and copies == [3, 3]
    assert (i == want).all()
    import jax.numpy as jnp

    jsm = JShardingManager(jbuild_mesh(1, 2))
    data, v, n = jsm.place_database(jnp.asarray(X), jnp.asarray(valid), jnp.asarray(sq))
    _, ji = jsm.sharded_knn(jnp.asarray(Q), data, v, n, k=K, metric=metric)
    assert sum(_misses(want, np.asarray(ji))) > 0


@pytest.fixture(scope="module")
def wide():
    """131,072 x 128 rows N(0, 1), 64 of them near duplicates c + N(0, 1e-5^2) of one
    c ~ N(0, 1); 8 queries c + N(0, 0.1^2), which fail the proof, and 12 gaussian ones,
    which pass it.  At 8 queries 8 x 256 windows x 32 rows fit: tier 1 exists."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1 << 17, D), dtype=np.float32)
    c = rng.standard_normal(D)
    x[rng.choice(x.shape[0], 64, replace=False)] = (
        c + rng.normal(0, 1e-5, (64, D))).astype(np.float32)
    near = (c + rng.normal(0, 0.1, (8, D))).astype(np.float32)
    far = rng.standard_normal((12, D), dtype=np.float32)
    sq = (x.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    return x, sq, {"widened": near, "contained": np.concatenate([near[:4], far])}


@pytest.mark.parametrize("case, failing", [("widened", 8), ("contained", 4)])
def test_c20_tier1_selects_the_failing_queries_again(wide, case, failing):
    """exact_knn_fused at 131,072 rows, l2, k = 16, the fast kernel: a batch of 8 whose
    every query fails escalates to tier 1 widened (the whole batch selected again at 8x
    the width, 256 windows); a batch of 16 with 4 failing queries to tier 1 contained
    (8 rows, the 4 failing first in stable order, selected again and proven again
    together).  Each gives the oracle's set and order; JAX's ``exact_knn_pallas`` misses
    rows of the failing queries."""
    x, sq, batches = wide
    q = batches[case]
    valid = np.ones(x.shape[0], bool)
    seen = []
    real = F._select_and_rescan

    def spy(qq, *a, **kw):
        seen.append((qq.shape[0], kw.get("s_sel")))
        return real(qq, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, "_select_and_rescan", spy)
        d, i, tier = F.exact_knn_fused(*(torch.from_numpy(a) for a in (q, x, valid, sq)),
                                       k=16, metric="l2", live_prefix=x.shape[0],
                                       report_tier=True)
    want, _ = _oracle(x, q, "l2", valid, k=16)
    assert tier == 1 and (i.numpy() == want).all()
    assert seen == [(len(q), None), (8, 8 * 32)]
    import jax.numpy as jnp

    _, ji = JF.exact_knn_pallas(*(jnp.asarray(a) for a in (q, x, valid, sq)), k=16,
                                metric="l2", live_prefix=x.shape[0])
    jm = _misses(want[:, :K], np.asarray(ji)[:, :K])
    assert min(jm[:failing]) > 0 and sum(jm[failing:]) == 0, jm


@pytest.mark.parametrize("metric", METRICS)
def test_c20_gaussian_rows_stay_at_tier_0_in_one_copy_each_way(metric):
    """Gaussian rows on the default config: every batch proven at tier 0 in one copy each
    way, the oracle's set and order; the proof's maxd kept in the snapshot's prep
    (cosine needs none)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N, D), dtype=np.float32)
    q = rng.standard_normal((B, D), dtype=np.float32)
    tqp = QueryProcessor(EngineConfig(), device="cpu")
    tqp.bulk_load(x, "g", ids=IDS)
    for b in (B, 3):
        xfer = dict(tqp.transfer_counts)
        got = _ids(tqp.find_similar_batch([VectorDTO(v) for v in q[:b]], K, "g", metric))
        want, _ = _oracle(x, q[:b], metric, np.ones(N, bool))
        assert (got == want).all()
        assert (tqp.transfer_counts["h2d"] - xfer["h2d"],
                tqp.transfer_counts["d2h"] - xfer["d2h"]) == (1, 1)
    assert tqp.cert_tier_counts("g") == {"fast": 2} and tqp.settle_copies == 0
    prep = tqp.storage.namespace("g").device_state().prep_cache
    assert (("row_major_maxd", N) in prep) == (metric != "cosine")


def test_c20_margin_mode_keeps_the_unproven_selection():
    """certify_exact=False: no proof and no tier recorded, the selection returned as the
    parent returned it (``exact_knn_fused(certify=False)``, tier -1); on the construction
    it misses the oracle's rows, as JAX's does."""
    tqp = QueryProcessor(EngineConfig(certify_exact=False), device="cpu")
    tqp.bulk_load(X, "ns", ids=IDS)
    got = _ids(tqp.find_similar_batch([VectorDTO(v) for v in Q], K, "ns", "l2"))
    sq = (X.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    qpad = np.zeros((B, D), np.float32)
    qpad[:] = Q
    d, i, tier = F.exact_knn_fused(*(torch.from_numpy(a) for a in (qpad, X, np.ones(N, bool),
                                                                     sq)),
                                   k=16, metric="l2", live_prefix=N, certify=False,
                                   report_tier=True)
    assert tier == -1 and (got == i.numpy()[:, :K]).all()
    assert tqp.cert_tier_counts("ns") == {}
    assert (tqp.transfer_counts["h2d"], tqp.transfer_counts["d2h"] - tqp.settle_copies) == (1, 1)
    want, _ = _oracle(X, Q, "l2", np.ones(N, bool))
    assert sum(_misses(want, got)) > 0


@pytest.mark.parametrize("variant", ["fast", "masked"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_c20_proof_err_bounds_phase1_against_float64(dtype, metric, variant):
    """The proof's err (``_row_maxd``, ``_Proof``) bounds |phase 1 - exact| of every
    live row: B4/B5's plain version (per row: r1 = 1) over the construction's rows, the
    near-duplicate queries, gaussian ones and a zero query, against float64 over the
    stored rows and the f32 query; a bf16 store's phase 1 scores the query rounded to
    bf16 (dq).  At l2, with a k-th d_k given, it bounds every live row within the k-th's
    ball (|x| <= |q| + sqrt(d_k)), the only rows that could beat it.  The kernels' own
    dots stay within the c = Dp 2^-23 of the table."""
    rows = torch.from_numpy(X).to(getattr(torch, dtype))
    rng = np.random.default_rng(20)
    q = np.concatenate([Q, rng.normal(0, 0.1, (3, D)), np.zeros((1, D))]).astype(np.float32)
    q32 = torch.from_numpy(q)
    qt = q32.T.to(rows.dtype).float().contiguous()
    qn = (q32 * q32).sum(-1)
    sq = (rows.double() ** 2).sum(-1).float()
    live = torch.ones(N, dtype=torch.bool)
    kw = dict(metric=metric, db_tile=F.DB_TILE, r1=1)
    if variant == "fast":
        hw = N - 100
        live[hw:] = False
        p = F._window_mins_fast_ref(rows, qt, qn[None], hw, **kw)
    else:
        live[GONE] = False
        maskadd = torch.where(live, 0.0, float(F.MASKED))
        bias = (sq + maskadd if metric == "l2" else maskadd).reshape(N, 1)
        p = F._window_mins_masked_ref(rows, qt, qn[None], bias, **kw)
    x64, q64 = rows.double(), q32.double()
    if metric == "l2":
        d64 = ((x64[:, None] - q64[None]) ** 2).sum(-1)
    elif metric == "ip":
        d64 = 1 - x64 @ q64.T
    else:
        nn = (x64 * x64).sum(-1)[:, None] * (q64 * q64).sum(-1)[None]
        d64 = 1 - (x64 @ q64.T) / torch.sqrt(torch.clamp_min(nn, 1e-30))
    dq = None if dtype == "float32" else torch.linalg.vector_norm(q32 - qt.T, dim=1)
    maxd = F._row_maxd(sq, live, D)
    gap = (p.double() - d64).abs()
    # every live row against maxd; at l2 each k-th's ball too: the rows within it
    proof = F._Proof(metric, maxd, qn, dq, D)
    err = proof.err(torch.full_like(qn, float("inf")))
    assert (gap[live] <= err[None]).all(), (gap[live] / err[None]).max()
    assert (gap[live] / err[None]).max() > 1e-3        # the bound is not vacuous
    if metric == "l2":
        for j in (1, 10, 100):                           # the j-th nearest as the k-th
            kth = d64.masked_fill(~live[:, None], float("inf")).kthvalue(j, dim=0).values
            ball = proof.err(kth.float())
            inside = live[:, None] & (torch.linalg.vector_norm(x64, dim=1)[:, None]
                                      <= torch.sqrt(q64 * q64).sum(-1).sqrt()[None]
                                      + kth.sqrt()[None])
            assert (gap <= ball[None])[inside].all()
