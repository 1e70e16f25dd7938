"""The k-bucket-128 certified sweep program of the port (the sweep kernel's per-tile top-m
pool, ``skip_wm``, ``_select_topm_and_rescan``) and range / similarity search, against the
JAX package on the CPU.

The port's kernel wrappers run their plain torch versions on CPU tensors; the JAX side
runs its Pallas kernels in interpret mode.  Inputs are made with numpy from a seed.

Tolerances:
  * pool values: fully masked windows equal (exactly 3e38); live values within the
    certificate's accumulation slack Dp * 2^-22 * |qh| * maxd per query, as the window
    mins themselves (both sides sum exact products in f32 in different orders);
  * pool positions: equal, except where the two sides order near-ties differently: then
    the window JAX picked has, in the port's own window mins, a value within twice that
    slack of the port's value at the same rank;
  * the +inf padding rows, and a NaN query's rows (NaN values, positions out_w): equal;
  * searches: tiers equal to the JAX package's, id sets equal.
"""

import types
import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlvectordb_tpu.config import EngineConfig as JaxConfig
from mlvectordb_tpu.engine.query_processor import QueryProcessor as JaxQueryProcessor
from mlvectordb_tpu.interfaces.vector import VectorDTO as JaxDTO
from mlvectordb_tpu.ops import backend as jax_backend
from mlvectordb_tpu.ops import pallas_knn_t as J
from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.ops import fused_knn_t as T
from mlvectordb_tpu_torch.ops.distances import MASKED

from .test_torch_sweep import _assert_same_sets, _both, _gaussian, _jax_rows, _t

D = 128
TILE = J.SWEEP_TILE


def _operands(seed, n, b, metric, heavy, nan_query=None):
    """Kernel B1's operands as the certified search builds them, with ~1% tombstones, a
    dead half tile, and a tile left with only 32 live rows (so the pool of that tile holds
    fully masked windows, equal values whose order is the position's)."""
    rng, db, q = _gaussian(seed, n, b)
    if nan_query is not None:
        q[nan_query, 5] = np.nan
    valid = rng.random(n) > 0.01
    valid[-TILE // 2:] = False
    valid[TILE : TILE + TILE // 2 - 32] = False
    sq = (db * db).sum(-1).astype(np.float32)
    z, s, e2, e1 = (x.numpy() for x in T.quantize_resid_rows(_t(db)))
    prep = T._prep_terms(_t(valid), _t(sq), n, _t(s), _t(e2), _t(e1), cap=n, metric=metric,
                         masked=True, use_resid=heavy, wb_sources=("sweep_err", "err1"))
    q_fold = (-2.0 if metric == "l2" else -1.0) * q
    qh32 = q_fold.astype(jnp.bfloat16).astype(np.float32)
    qres32 = (q_fold - qh32).astype(jnp.bfloat16).astype(np.float32) if heavy else None
    scale = None if prep["scale_row"] is None else prep["scale_row"].numpy()
    ebs = [e.numpy() for e in prep["eb_rows"]]
    qe = rng.random((b, 2)).astype(np.float32) * 4.0
    resid, rscale = (z, s) if heavy else (None, None)
    jax_args = (jnp.asarray(qh32, jnp.bfloat16),
                None if qres32 is None else jnp.asarray(qres32, jnp.bfloat16),
                J.to_sweep_layout(jnp.asarray(db), dtype=jnp.bfloat16),
                None if resid is None else J.to_sweep_layout(jnp.asarray(resid)),
                _jax_rows(rscale), _jax_rows(scale), _jax_rows(prep["bias_row"].numpy()))
    jax_kw = dict(qe=jnp.pad(jnp.asarray(qe), ((0, 0), (0, 126))),
                  eb_rows=tuple(_jax_rows(e) for e in ebs))
    torch_args = (_t(qh32).to(torch.bfloat16),
                  None if qres32 is None else _t(qres32).to(torch.bfloat16),
                  _t(db).to(torch.bfloat16), None if resid is None else _t(resid),
                  None if rscale is None else _t(rscale), None if scale is None else _t(scale),
                  prep["bias_row"])
    torch_kw = dict(qe=_t(qe), eb_rows=tuple(map(_t, ebs)))
    maxd = 1.0 if metric == "cosine" else float(np.sqrt(sq[valid].max()))
    slack = D * 2.0 ** -22 * np.linalg.norm(np.nan_to_num(q_fold), axis=1) * maxd   # [B]
    return (jax_args, jax_kw), (torch_args, torch_kw), slack


def _decode(pool, m, out_w):
    """numpy [nt, SUB, B] pool -> numpy (values, positions), each [nt, m, B]."""
    return tuple(x.numpy() for x in T._decode_topm(_t(pool), m, out_w))


@pytest.mark.parametrize("skip_wm", [False, True])
@pytest.mark.parametrize("r1,m", [(16, 8), (16, 16), (8, 8)])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("variant", ["light", "heavy"])
def test_pool_plain_matches_pallas(variant, metric, r1, m, skip_wm):
    n, b = 2 * TILE, 8
    g, out_w = 32 // r1, (32 // r1) * 128
    (ja, jk), (ta, tk), slack = _operands(r1 * 31 + m + len(metric), n, b, metric,
                                          variant == "heavy")
    want = J._window_mins(*ja, q_tile=b, g=g, transposed=True, emit_topm=m,
                          skip_wm=skip_wm, **jk)
    want = np.asarray(want if skip_wm else want[1])
    wmin, bm, pool = T._window_mins_t(*ta, r1=r1, emit_topm=m, skip_wm=skip_wm, **tk)
    assert bm is None and (wmin is None) == skip_wm
    if skip_wm:  # the port's own window mins, for the tie rule below
        wmin = T._window_mins_t(*ta, r1=r1, **tk)[0]
    got, wmin = pool.numpy(), wmin.numpy()
    sub = J._topm_sub_rows(m)
    assert got.shape == want.shape == (n // TILE, sub, b)
    # padding rows
    np.testing.assert_array_equal(got[:, m + (m + 1) // 2:], want[:, m + (m + 1) // 2:])
    assert np.isinf(got[:, m + (m + 1) // 2:]).all()
    gv, gp = _decode(got, m, out_w)
    wv, wp = _decode(want, m, out_w)
    dead = wv == MASKED
    assert dead.any() and (~dead).any()
    np.testing.assert_array_equal(gv[dead], wv[dead])
    sl = slack[None, None, :]
    assert (np.where(dead, 0.0, np.abs(gv - wv)) <= sl).all()
    # positions: equal unless JAX's pick is a near-tie of the port's in the port's mins
    t_i, j_i, b_i = np.nonzero(gp != wp)
    at_jax_pick = wmin[t_i, b_i, wp[t_i, j_i, b_i]]
    assert (np.abs(at_jax_pick - gv[t_i, j_i, b_i]) <= 2 * slack[b_i]).all()
    assert len(t_i) <= gp.size // 20, len(t_i)


def test_nan_query_pool_matches_pallas():
    n, b, r1, m = 2 * TILE, 8, 16, 8
    out_w = 256
    (ja, jk), (ta, tk), _ = _operands(7, n, b, "l2", False, nan_query=3)
    want = np.asarray(J._window_mins(*ja, q_tile=b, g=2, transposed=True, emit_topm=m,
                                     skip_wm=True, **jk))
    got = T._window_mins_t(*ta, r1=r1, emit_topm=m, skip_wm=True, **tk)[2].numpy()
    for pool in (got, want):
        assert np.isnan(pool[:, :m, 3]).all()
        assert (pool[:, m : m + m // 2, 3] == out_w + out_w * out_w).all()
        assert not np.isnan(np.delete(pool, 3, axis=2)).any()
    np.testing.assert_array_equal(got[:, m:, 3], want[:, m:, 3])


def test_pool_operand_checks():
    n, b = 2 * TILE, 8
    mirror = torch.zeros((n, D), dtype=torch.bfloat16)
    qh = torch.zeros((b, D), dtype=torch.bfloat16)
    bias = torch.zeros(n)

    def check(r1=16, bm=False, m=8, skip=False):
        T._check_sweep_operands(qh, None, mirror, None, None, None, bias, None, (), r1, bm,
                                m, skip)

    check()
    check(r1=8, m=8, skip=True)
    check(r1=32, m=32)
    for bad in (dict(m=10, r1=8),              # m * g > 32
                dict(m=9),                     # odd m
                dict(m=6),                     # below the kernel's 8
                dict(r1=32, m=8, bm=True),     # the pool beside the block mins
                dict(m=0, skip=True)):         # skip_wm without the pool
        with pytest.raises(ValueError):
            check(**bad)
    # the plain version refuses the combinations the JAX package refuses
    for bad in (dict(emit_block_mins=True, emit_topm=8), dict(skip_wm=True)):
        with pytest.raises(ValueError):
            T._window_mins_t(qh, None, mirror, None, None, None, bias, r1=32, **bad)


# ------------------------------------------------------------------ searches


@pytest.mark.parametrize("b", [8, 16])
def test_k100_pool_search_matches_jax(b):
    """32 tiles, k=100: m=16 at g=2; B=8 keeps the window mins (tier 2 exists), B=16
    writes the pool only."""
    _, db, q = _gaussian(101 + b, 32 * TILE, b)
    j, t = _both(db, q, np.ones(32 * TILE, bool), metric="l2", k=100)
    assert t[2] == j[2] == 0
    for i in range(b):
        assert set(t[1][i].tolist()) == set(j[1][i].tolist()), i


def test_k32_pool_search_matches_jax():
    _, db, q = _gaussian(103, 32 * TILE, 8)
    valid = np.ones(32 * TILE, bool)
    valid[::97] = False                         # the masked variant
    j, t = _both(db, q, valid, metric="cosine", k=32, light=True)
    assert t[2] == j[2] == 0
    for i in range(8):
        assert set(t[1][i].tolist()) == set(j[1][i].tolist()), i
    assert valid[t[1]].all()


def test_ip_proof_failure_escalates_like_jax(monkeypatch):
    """Gaussian ip traffic on a tombstoned corpus, k=100, B=32: no tier 2 at this batch, so
    the kernel writes the pool only (m=8) and a failed light proof goes straight to the
    exact scan.  Query 23's proof fails; JAX serves the batch from the exact scan as the
    port does, and with query 23 replaced by a passing one both serve it at tier 0, so the
    failing query is JAX's as well as the port's."""
    rng = np.random.default_rng(0)
    n = 1 << 18
    db = rng.standard_normal((n, D), dtype=np.float32)
    q = rng.standard_normal((32, D), dtype=np.float32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, 250, replace=False)] = False
    outputs = []
    real = T._window_mins_t

    def spy(*a, **kw):
        outputs.append((kw["emit_topm"], kw["skip_wm"]))
        return real(*a, **kw)

    monkeypatch.setattr(T, "_window_mins_t", spy)
    data = _t(db)
    z, s, e2, e1 = T.quantize_resid_rows(data)
    res = T.exact_knn_t(_t(q), data.to(torch.bfloat16), data, _t(valid), (data * data).sum(-1),
                        k=100, metric="ip", sweep_err=e2, resid=z, rscale=s, err1=e1,
                        light=True, defer=True)
    assert np.nonzero(~res.okq.numpy())[0].tolist() == [23]
    j, t = _both(db, q, valid, metric="ip", k=100, light=True)
    assert t[2] == j[2] == 2
    _assert_same_sets(j, t)
    q[23] = q[0]
    j, t = _both(db, q, valid, metric="ip", k=100, light=True)
    assert t[2] == j[2] == 0
    _assert_same_sets(j, t)
    assert outputs == [(8, True)] * 3


def test_pool_overflow_escalates_like_jax():
    """20 hot windows inside one tile (tests/test_pallas_t.py:631-659): the pool surfaces
    its 8 best, the floor drops below the k-th found distance, and both sides escalate."""
    rng = np.random.default_rng(104)
    n, k, r1 = 32 * TILE, 32, 16
    db = rng.standard_normal((n, D)).astype(np.float32) * 4.0
    qv = rng.standard_normal(D).astype(np.float32)
    for i in range(20):
        db[i * r1] = qv + rng.standard_normal(D).astype(np.float32) * 0.01
    q = np.broadcast_to(qv, (8, D)).copy()
    j, t = _both(db, q, np.ones(n, bool), metric="l2", k=k)
    assert t[2] == j[2] >= 1
    d64 = ((q[:1].astype(np.float64) - db) ** 2).sum(-1)
    oracle = set(np.argsort(d64)[:k].tolist())
    for i in range(8):
        assert set(t[1][i].tolist()) == set(j[1][i].tolist()) == oracle, i


def test_nan_query_escalates_like_jax():
    """A NaN query fails its proof on both sides (JAX's NaN rule in the pool and in the
    window mins), so the batch is served by the exact scan."""
    _, db, q = _gaussian(105, 32 * TILE, 8)
    q[2, 7] = np.nan
    for k in (10, 100):
        j, t = _both(db, q, np.ones(32 * TILE, bool), metric="l2", k=k, light=True)
        assert t[2] == j[2] == 2, k
        for i in (0, 1, 3):
            assert set(t[1][i].tolist()) == set(j[1][i].tolist()), (k, i)


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def engines():
    """One 2^18-row sweep namespace in the JAX engine and in the port's (on the CPU).  The
    JAX engine picks its certified sweep backend only on a TPU; here it is told it runs on
    one, and its Pallas kernels still run in interpret mode (pallas_knn_t asks jax itself)."""
    rng = np.random.default_rng(2025)
    n = 1 << 18
    x = rng.standard_normal((n, D), dtype=np.float32)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, n)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backend, "jax", types.SimpleNamespace(default_backend=lambda: "tpu"))
        jqp = JaxQueryProcessor(config=JaxConfig(sweep_dtype="bfloat16"))
        tqp = QueryProcessor(EngineConfig(sweep_dtype="bfloat16"), device="cpu")
        metas = [{"p": i % 2} for i in range(n)]
        jqp.bulk_load(x, "ns", ids=ids, metadatas=metas)
        tqp.bulk_load(x, "ns", ids=ids, metadatas=metas)
        assert tqp.storage.namespace("ns").capacity == n
        yield rng, x, jqp, tqp


@pytest.mark.parametrize("b", [8, 64])
def test_engine_k100_matches_jax(engines, b, monkeypatch):
    """k=100 runs k bucket 128 at 64 tiles: the pool with m=10; bucket 8 keeps the window
    mins for tier 2, bucket 64 writes the pool only."""
    rng, x, jqp, tqp = engines
    queries = rng.standard_normal((b, D), dtype=np.float32)
    before = dict(tqp.transfer_counts)
    launches = T._window_mins_t.launches
    outputs = []
    real = T._window_mins_t

    def spy(*a, **kw):
        outputs.append((kw["emit_topm"], kw["skip_wm"], kw["emit_block_mins"]))
        return real(*a, **kw)

    monkeypatch.setattr(T, "_window_mins_t", spy)
    jr = jqp.find_similar_batch([JaxDTO(v) for v in queries], 100, "ns", "l2")
    tr = tqp.find_similar_batch([VectorDTO(v) for v in queries], 100, "ns", "l2")
    assert (tqp.transfer_counts["h2d"] - before["h2d"],
            tqp.transfer_counts["d2h"] - before["d2h"]) == (1, 1)
    assert real.launches == launches                      # CPU tensors: the plain version
    for a, c in zip(jr, tr):
        assert len(c) == 100 and {r["id"] for r in a} == {r["id"] for r in c}
        np.testing.assert_allclose(sorted(r["score"] for r in c),
                                   sorted(r["score"] for r in a), rtol=1e-4, atol=1e-4)
    assert outputs == [(10, b == 64, False)]
    assert tqp.cert_tier_counts("ns") == jqp.cert_tier_counts("ns")
    assert set(tqp.cert_tier_counts("ns")) == {"light_fast"}


def test_engine_range_and_similarity_search_match_jax(engines):
    rng, x, jqp, tqp = engines
    qv = rng.standard_normal(D).astype(np.float32)
    d64 = ((qv.astype(np.float64) - x) ** 2).sum(-1)
    # radius and threshold halfway between the 50th and 51st hit: no tie at the edge
    radius = float(np.sort(d64)[49:51].mean())
    cos = (x.astype(np.float64) @ qv) / (np.linalg.norm(x, axis=1) * np.linalg.norm(qv))
    threshold = float(np.sort(cos)[::-1][49:51].mean())
    cases = [("range", dict(radius=radius, limit=100)),
             ("range", dict(radius=radius)),
             ("similarity", dict(threshold=threshold)),
             ("similarity", dict(threshold=threshold, limit=100))]
    for kind, kw in cases:
        if kind == "range":
            jr = jqp.range_search(JaxDTO(qv), namespace="ns", **kw)
            tr = tqp.range_search(VectorDTO(qv), namespace="ns", **kw)
        else:
            jr = jqp.similarity_search(JaxDTO(qv), namespace="ns", **kw)
            tr = tqp.similarity_search(VectorDTO(qv), namespace="ns", **kw)
        assert len(tr) == 50, (kind, kw, len(tr))
        assert [r["id"] for r in tr] == [r["id"] for r in jr], (kind, kw)
        np.testing.assert_allclose([r["score"] for r in tr], [r["score"] for r in jr],
                                   rtol=1e-5, atol=1e-4)
    assert tqp.cert_tier_counts("ns") == jqp.cert_tier_counts("ns")
    # with a filter (the masked sweep program): the same hits within the radius, none
    # outside the filter
    spec = {"p": 1}
    for kind, kw in (("range", dict(radius=radius, limit=100)),
                     ("similarity", dict(threshold=threshold, limit=100))):
        if kind == "range":
            jr = jqp.range_search(JaxDTO(qv), namespace="ns", filter=spec, **kw)
            tr = tqp.range_search(VectorDTO(qv), namespace="ns", filter=spec, **kw)
        else:
            jr = jqp.similarity_search(JaxDTO(qv), namespace="ns", filter=spec, **kw)
            tr = tqp.similarity_search(VectorDTO(qv), namespace="ns", filter=spec, **kw)
        assert 10 < len(tr) < 50 and all(r["metadata"]["p"] == 1 for r in tr), (kind, len(tr))
        assert [r["id"] for r in tr] == [r["id"] for r in jr], kind
        np.testing.assert_allclose([r["score"] for r in tr], [r["score"] for r in jr],
                                   rtol=1e-5, atol=1e-4)
    assert tqp.cert_tier_counts("ns") == jqp.cert_tier_counts("ns")
    assert tqp.range_search(VectorDTO(qv), 1.0, "missing") == []
