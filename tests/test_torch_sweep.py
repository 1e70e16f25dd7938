"""The certified bf16-sweep path of the port (ops/fused_knn_t and its store and engine
plumbing) against the JAX package's (ops/pallas_knn_t), on the CPU.

The port's kernel wrappers run their plain torch versions on CPU tensors; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_pallas_t.py runs them.  Inputs
are made with numpy from a seed and handed to both.  The JAX mirror is window-major
[Dp, cap] and the port's row-major [cap, Dp]; both describe the same windows of r1
consecutive store rows, so the tile-major window-min outputs compare element by element.

Tolerances:
  * int8 residual codes and their scales: bit-equal (both sides divide and round half
    to even in f32); error norms within 1 ulp * sqrt(Dp) (another summation order);
  * window mins: fully masked windows equal (exactly 3e38); live windows within the
    certificate's own accumulation slack Dp * 2^-22 * |qh| * maxd per query (cosine:
    maxd = 1), since both sides sum exact products in f32 in different orders;
  * searches: the id sets equal the scan's on gaussian data; on clustered data, where
    ties make id sets ambiguous, the sorted distances within 1e-4 relative + 1e-5; the
    certificate tier equal to the JAX package's.
"""

import uuid

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlvectordb_tpu.config import EngineConfig as JaxConfig
from mlvectordb_tpu.engine.query_processor import QueryProcessor as JaxQueryProcessor
from mlvectordb_tpu.interfaces.vector import VectorDTO as JaxDTO
from mlvectordb_tpu.ops import pallas_knn_t as J
from mlvectordb_tpu.store.namespace import NamespaceStore as JaxNamespaceStore
from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO, convert
from mlvectordb_tpu_torch.ops import fused_knn_t as T
from mlvectordb_tpu_torch.ops.backend import knn_backend
from mlvectordb_tpu_torch.ops.distances import MASKED
from mlvectordb_tpu_torch.ops.topk import exact_knn

D = 128
TILE = J.SWEEP_TILE
SWEEP = EngineConfig(sweep_dtype="bfloat16")


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _gaussian(seed, n, b):
    rng = np.random.default_rng(seed)
    return (rng, rng.standard_normal((n, D), dtype=np.float32),
            rng.standard_normal((b, D), dtype=np.float32))


def _clustered(seed, n, b, n_centres, spread, noise):
    """The corpora of tests/test_pallas_t.py: tight clusters whose neighbour gaps sit
    below the bf16 band."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((n_centres, D)).astype(np.float32) * spread
    db = centres[rng.integers(0, n_centres, n)] + rng.standard_normal((n, D)).astype(
        np.float32) * noise
    q = centres[rng.integers(0, n_centres, b)] + rng.standard_normal((b, D)).astype(
        np.float32) * noise
    return rng, db.astype(np.float32), q.astype(np.float32)


def _both(db, q, valid, *, metric, k, light=False, live_prefix=None,
          tuning=T.DEFAULT_TUNING, **kw):
    """The same search through the JAX entry (interpret mode) and the port's (with
    ``tuning``): ((dist, idx, tier) of JAX, of the port) as numpy arrays and ints."""
    n = db.shape[0]
    sq = (db * db).sum(-1).astype(np.float32)
    z, s, e2, e1 = (np.asarray(x) for x in J.quantize_resid_rows(jnp.asarray(db)))
    lp = n if live_prefix is None and valid.all() else live_prefix
    jd, ji, jt = J.exact_knn_pallas_t(
        jnp.asarray(q), J.to_sweep_layout(jnp.asarray(db), dtype=jnp.bfloat16),
        jnp.asarray(db), jnp.asarray(valid), jnp.asarray(sq), k=k, metric=metric,
        live_prefix=lp, sweep_err=jnp.asarray(e2), resid=J.to_sweep_layout(jnp.asarray(z)),
        rscale=jnp.asarray(s), err1=jnp.asarray(e1), light=light, report_tier=True, **kw)
    td, ti, tt = T.exact_knn_t(
        _t(q), _t(db).to(torch.bfloat16), _t(db), _t(valid), _t(sq), k=k, metric=metric,
        live_prefix=lp, sweep_err=_t(e2), resid=_t(z), rscale=_t(s), err1=_t(e1),
        light=light, report_tier=True, tuning=tuning, **kw)
    return (np.asarray(jd), np.asarray(ji), int(jt)), (td.numpy(), ti.numpy(), tt)


def _assert_same_sets(j, t, oracle_ids=None):
    for b in range(t[1].shape[0]):
        assert set(t[1][b].tolist()) == set(j[1][b].tolist()), b
        if oracle_ids is not None:
            assert set(t[1][b].tolist()) == set(oracle_ids[b].tolist()), b
    np.testing.assert_allclose(np.sort(t[0], 1), np.sort(j[0], 1), rtol=1e-4, atol=1e-4)


def _assert_same_distances(j, t, scale=None):
    """Sorted distances within 1e-4 relative + 1e-5, plus, for l2, the f32 cancellation
    of the expansion qn + sqn - 2 q.x: 16 ulps of ``scale`` = qn + max sqn per query."""
    atol = 1e-5 if scale is None else 1e-5 + 16 * 2.0 ** -24 * scale[:, None]
    got, want = np.sort(t[0], 1), np.sort(j[0], 1)
    assert (np.abs(got - want) <= 1e-4 * np.abs(want) + atol).all(), np.abs(got - want).max()


def _l2_scale(db, q):
    return (q * q).sum(-1) + (db * db).sum(-1).max()


# ------------------------------------------------------------------ quantizers


def test_quantizers_match_jax():
    rng = np.random.default_rng(1)
    db = rng.standard_normal((8192, D)).astype(np.float32) * 3.0
    db[:8] = 0.0                                  # all-zero rows: scale 0, codes 0
    db[8] = np.float32(1.0)                       # bf16-exact row: delta 0
    z, s, e2, e1 = (np.asarray(x) for x in J.quantize_resid_rows(jnp.asarray(db)))
    tz, ts, te2, te1 = (x.numpy() for x in T.quantize_resid_rows(_t(db)))
    assert tz.dtype == np.int8 and np.array_equal(tz, z)
    assert np.array_equal(ts, s)
    ulp = np.sqrt(D) * np.float32(2.0 ** -23)
    for got, want in ((te2, e2), (te1, e1),
                      (T.sweep_err_norms(_t(db)).numpy(),
                       np.asarray(J.sweep_err_norms(jnp.asarray(db))))):
        assert np.all(np.abs(got - want) <= ulp * np.abs(want) + 1e-30)
    # round half to even on both sides: a residual of exactly 0.5 scale units
    half = np.zeros((1, D), np.float32)
    half[0, :2] = np.float32(1.0) + np.float32(2.0 ** -9) * np.array([1, 0.5], np.float32)
    np.testing.assert_array_equal(T.quantize_resid_rows(_t(half))[0].numpy(),
                                  np.asarray(J.quantize_resid_rows(jnp.asarray(half))[0]))


def test_pick_r1_and_constants_match_jax():
    assert (T.SWEEP_TILE, T.R1MAX, T.WLANE, T.Q_TILE, T.R2) == (
        J.SWEEP_TILE, J.R1MAX, J.WLANE, J.Q_TILE, J.R2)
    assert T.Tuning() == T.Tuning(J.SORT_TOPK_FROM, J.BLOCKTOP_ENABLE, J.MB_BLOCKTOP,
                                  J.CONTAIN_ENABLE, J.TOPM_ENABLE)
    assert J.TOPM_BM is False   # the port has no pool on block-min-eligible shapes
    for m in (1, 7, 8, 10, 16, 20, 32):
        assert T._topm_sub_rows(m) == J._topm_sub_rows(m)
    for b in (1, 8, 64, 512, 4096):
        for n in (8192, 1 << 20, 1 << 24):
            for k in (1, 10, 16, 17, 100, 128, 129, 256, 300, 1024):
                assert T._pick_r1(b, n, k) == J._pick_r1(b, n, k)
    p = torch.arange(3 * 4 * 128)
    np.testing.assert_array_equal(T._pos_to_window(p, 4).numpy(),
                                  np.asarray(J._pos_to_window(jnp.asarray(p.numpy()), 4)))


# ------------------------------------------------------------------ kernel B1


def _jax_rows(x):
    return None if x is None else J.sweep_rows_1d(jnp.asarray(x)).reshape(1, -1)


@pytest.mark.parametrize("variant", ["light", "heavy"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("r1", [32, 16, 4])
def test_window_mins_plain_matches_pallas(variant, metric, r1):
    n, b = 8192, 8
    rng, db, q = _gaussian(r1 * 7 + len(metric), n, b)
    valid = rng.random(n) > 0.01                  # ~1% tombstones
    valid[-TILE // 2:] = False                    # and whole dead windows
    sq = (db * db).sum(-1).astype(np.float32)
    z, s, e2, e1 = (x.numpy() for x in T.quantize_resid_rows(_t(db)))
    prep = T._prep_terms(_t(valid), _t(sq), n, _t(s), _t(e2), _t(e1), cap=n, metric=metric,
                         masked=True, use_resid=variant == "heavy",
                         wb_sources=("sweep_err", "err1"))
    bias, scale = prep["bias_row"].numpy(), prep["scale_row"]
    scale = None if scale is None else scale.numpy()
    ebs = [e.numpy() for e in prep["eb_rows"]]
    q_fold = (-2.0 if metric == "l2" else -1.0) * q
    qh32 = q_fold.astype(jnp.bfloat16).astype(np.float32)
    qh = jnp.asarray(q_fold, jnp.bfloat16)
    qres = jnp.asarray(q_fold - qh32, jnp.bfloat16) if variant == "heavy" else None
    qe = rng.random((b, 2)).astype(np.float32) * 4.0
    resid, rscale = (z, s) if variant == "heavy" else (None, None)
    bm_on = r1 == 32
    want = J._window_mins(
        qh, qres, J.to_sweep_layout(jnp.asarray(db), dtype=jnp.bfloat16),
        None if resid is None else J.to_sweep_layout(jnp.asarray(resid)), _jax_rows(rscale),
        _jax_rows(scale), _jax_rows(bias), q_tile=b, g=32 // r1, transposed=True,
        emit_block_mins=bm_on, qe=jnp.pad(jnp.asarray(qe), ((0, 0), (0, 126))),
        eb_rows=tuple(_jax_rows(e) for e in ebs))
    launches = T._window_mins_t.launches
    got, bm, pool = T._window_mins_t(
        _t(np.asarray(qh.astype(jnp.float32))).to(torch.bfloat16),
        None if qres is None else _t(np.asarray(qres.astype(jnp.float32))).to(torch.bfloat16),
        _t(db).to(torch.bfloat16), None if resid is None else _t(resid),
        None if rscale is None else _t(rscale), None if scale is None else _t(scale),
        _t(bias), r1=r1, emit_block_mins=bm_on, qe=_t(qe), eb_rows=tuple(map(_t, ebs)))
    assert T._window_mins_t.launches == launches  # CPU tensors: the plain version
    assert pool is None and (bm is None) == (not bm_on)
    pairs = [(got.numpy(), want)]
    if bm_on:
        want, want_bm = want
        # block mins [nt, B] against the JAX [nt, 8, B] broadcast (a Mosaic block rule)
        pairs = [(got.numpy(), want), (bm.numpy()[:, :, None], np.asarray(want_bm)[:, 0, :, None])]
    assert pairs[0][0].shape == np.asarray(pairs[0][1]).shape == (n // TILE, b, (32 // r1) * 128)
    maxd = 1.0 if metric == "cosine" else float(np.sqrt(sq[valid].max()))
    slack = (D * 2.0 ** -22 * np.linalg.norm(q_fold, axis=1) * maxd)[None, :, None]  # [B]
    for got_a, want_a in pairs:
        want_a = np.asarray(want_a)
        dead = want_a == MASKED
        assert (~dead).any() and (dead.any() or got_a is not pairs[0][0])
        np.testing.assert_array_equal(got_a[dead], want_a[dead])
        err = np.where(dead, 0.0, np.abs(got_a - want_a))
        assert (err <= slack).all(), float((err / slack).max())


def test_window_mins_operand_checks():
    n, b = 8192, 8
    mirror = torch.zeros((n, D), dtype=torch.bfloat16)
    qh = torch.zeros((b, D), dtype=torch.bfloat16)
    bias = torch.zeros(n)
    T._check_sweep_operands(qh, None, mirror, None, None, None, bias, None, (), 32, True)
    bad = [
        dict(qh=qh.float()),                                   # dtype
        dict(bias=torch.zeros(n - 1)),                         # rows
        dict(mirror=torch.zeros((n - 4096 // 2, D), dtype=torch.bfloat16)),  # whole tiles
        dict(r1=3),                                            # window width
        dict(r1=16, bm=True),                                  # block mins need r1 = 32
        dict(resid=torch.zeros((n, D), dtype=torch.int8)),     # codes without scales
        dict(eb_rows=(bias,)),                                 # bounds without qe
        dict(qh=torch.zeros((D, b), dtype=torch.bfloat16).T),  # contiguity
    ]
    for case in bad:
        args = dict(qh=qh, mirror=mirror, bias=bias, r1=32, bm=False, resid=None,
                    eb_rows=())
        args.update(case)
        with pytest.raises(ValueError):
            T._check_sweep_operands(args["qh"], None, args["mirror"], args["resid"], None,
                                    None, args["bias"], None, args["eb_rows"], args["r1"],
                                    args["bm"])


# ------------------------------------------------------------------ kernel B2


def test_gather_score_operand_checks():
    q, data = torch.zeros((8, D)), torch.zeros((8192, D))
    f = torch.zeros((8, 20), dtype=torch.int32)
    T._check_gather_operands(q, data, f, 4)
    bad = [(q.double(), data, f, 4), (q, data, f.long(), 4), (q[:, :64], data, f, 4),
           (q, data[:, :100], f, 4), (q, data, f, 3), (q, data, f.T.contiguous().T, 4),
           (q, data.view(-1)[1:1 + 8188 * D].view(8188, D), f, 4)]   # not 16-byte aligned
    for args in bad:
        with pytest.raises(ValueError):
            T._check_gather_operands(*args)


def test_gather_score_plain_matches_score():
    rng, db, q = _gaussian(5, 8192, 8)
    f = np.sort(rng.choice(8192 // 4, (8, 40), replace=True), axis=1).astype(np.int32)
    dots, sqn = T._gather_score(_t(q), _t(db), _t(f), r1=4)
    rows = (f[:, :, None] * 4 + np.arange(4)).reshape(8, -1)
    sub = db[rows]
    np.testing.assert_allclose(dots.numpy(), (sub * q[:, None, :]).sum(-1), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(sqn.numpy(), (sub * sub).sum(-1), rtol=1e-5, atol=1e-4)
    assert T._gather_score.launches == 0


# ------------------------------------------------------------------ searches


@pytest.mark.parametrize("light", [True, False])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_gaussian_serves_tier0_like_jax(metric, light, oracle):
    _, db, q = _gaussian(11, 2 * TILE, 8)
    j, t = _both(db, q, np.ones(2 * TILE, bool), metric=metric, k=10, light=light)
    assert t[2] == j[2] == 0
    _assert_same_sets(j, t, oracle(q, db, 10, metric)[1])
    assert t[1].dtype == np.int32 and t[1].shape == (8, 10)
    # and the port's own scan, the results contract every backend honours
    sd, si = exact_knn(_t(q), _t(db), torch.ones(2 * TILE, dtype=torch.bool),
                       _t((db * db).sum(-1)), k=10, metric=metric)
    _assert_same_sets((sd.numpy(), si.numpy()), t)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_masked_gaussian_excludes_tombstones_like_jax(metric):
    rng, db, q = _gaussian(12, 4 * TILE, 16)
    valid = rng.random(4 * TILE) > 0.05
    q = db[:16] + np.float32(1e-3)                # the nearest rows are the queried ones...
    valid[:16:2] = False                          # ...and every other one of them is dead
    j, t = _both(db, q, valid, metric=metric, k=10, light=True)
    assert t[2] == j[2]
    _assert_same_sets(j, t)
    assert valid[t[1]].all()


def test_clustered_light_escalates_to_exact_scan_like_jax():
    _, db, q = _clustered(21, 2 * TILE, 8, 8, 0.05, 1e-3)
    j, t = _both(db, q, np.ones(2 * TILE, bool), metric="l2", k=10, light=True)
    assert t[2] == j[2] == 2
    _assert_same_distances(j, t)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_clustered_heavy_tier_matches_jax(metric):
    _, db, q = _clustered(22, 2 * TILE, 8, 16, 4.0, 0.02)
    j, t = _both(db, q, np.ones(2 * TILE, bool), metric=metric, k=10, light=False)
    assert t[2] == j[2]
    _assert_same_distances(j, t, _l2_scale(db, q) if metric == "l2" else None)


@pytest.mark.parametrize("pool", [False, True])
def test_k100_matches_jax_program_without_pool(monkeypatch, pool):
    # 32 tiles, k=100: JAX's pool program (m=16, g=2) by default; Tuning(topm_enable=False)
    # is its MLVDB_TOPM=0 program, held to JAX's own pool-off program
    monkeypatch.setattr(J, "TOPM_ENABLE", pool)
    _, db, q = _gaussian(31, 32 * TILE, 8)
    launches = T._window_mins_t.launches_topm
    tuning = T.Tuning() if pool else T.Tuning(topm_enable=False)
    j, t = _both(db, q, np.ones(32 * TILE, bool), metric="l2", k=100, tuning=tuning)
    assert t[2] == j[2] == 0
    _assert_same_sets(j, t)
    assert T._window_mins_t.launches_topm == launches  # CPU tensors: the plain version


def test_k1024_bucket_matches_jax():
    # r1 = 4, g = 8: the widest tile-major output, the chunked level-2 selection
    _, db, q = _gaussian(32, 4 * TILE, 4)
    j, t = _both(db, q, np.ones(4 * TILE, bool), metric="l2", k=1000)
    assert t[2] == j[2]
    _assert_same_sets(j, t)


def test_contained_escalation_matches_jax():
    """One query aims at a tight far-away cluster that the light band cannot separate;
    the other 15 are benign.  Only that query's proof fails, so both sides re-prove an
    8-query sub-batch at the tier-2 width and report tier 1 without the exact scan.  The
    cluster's distances (~1e-4) lie far inside l2's f32 cancellation band: JAX returns
    its f32 values, within that band of the port's; the port returns fl32 of the float64
    distances, in their order (ROADMAP C18)."""
    n = 20 * TILE                                  # 16 queries x 160 windows x 32 rows
    rng, db, q = _gaussian(41, n, 16)
    centre = np.full(D, 4.0, np.float32)
    db[1000:1800] = centre + rng.standard_normal((800, D)).astype(np.float32) * 1e-3
    q[0] = centre + rng.standard_normal(D).astype(np.float32) * 1e-3
    j, t = _both(db, q, np.ones(n, bool), metric="l2", k=10, light=True)
    assert t[2] == j[2] == 1
    _assert_same_distances(j, t, scale=_l2_scale(db, q))
    exact = ((db[t[1]].astype(np.float64) - q[:, None, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(t[0], exact.astype(np.float32))
    assert (np.diff(exact, axis=1) >= 0).all()
    _assert_same_sets((j[0][1:], j[1][1:]), (t[0][1:], t[1][1:]))


def test_small_capacity_goes_to_scan_like_jax():
    _, db, q = _gaussian(51, TILE, 4)
    j, t = _both(db, q, np.ones(TILE, bool), metric="l2", k=5)
    assert t[2] == j[2] == -1
    np.testing.assert_array_equal(t[1], j[1])


def test_prep_cache_and_search_prep():
    _, db, q = _gaussian(61, 2 * TILE, 8)
    n = 2 * TILE
    sq, valid = _t((db * db).sum(-1)), torch.ones(n, dtype=torch.bool)
    z, s, e2, e1 = T.quantize_resid_rows(_t(db))
    kw = dict(k=10, metric="cosine", live_prefix=n, sweep_err=e2, resid=z, rscale=s,
              err1=e1)
    args = (_t(q), _t(db).to(torch.bfloat16), _t(db), valid, sq)
    d0, i0 = T.exact_knn_t(*args, **kw)
    cache = {}
    d1, i1 = T.exact_knn_t(*args, prep_cache=cache, **kw)
    assert len(cache) == 1
    d2, i2 = T.exact_knn_t(*args, prep_cache=cache, **kw)       # served from the cache
    prep = T.search_prep(args[1], valid, sq, **{a: v for a, v in kw.items() if a != "k"})
    d3, i3 = T.exact_knn_t(*args, prep=prep, **kw)
    for d, i in ((d1, i1), (d2, i2), (d3, i3)):
        assert torch.equal(d, d0) and torch.equal(i, i0)


def test_deferred_result_carries_the_proof():
    _, db, q = _clustered(71, 2 * TILE, 8, 8, 0.05, 1e-3)
    n = 2 * TILE
    z, s, e2, e1 = T.quantize_resid_rows(_t(db))
    res = T.exact_knn_t(_t(q), _t(db).to(torch.bfloat16), _t(db), torch.ones(n, dtype=bool),
                        _t((db * db).sum(-1)), k=10, metric="l2", live_prefix=n,
                        sweep_err=e2, resid=z, rscale=s, err1=e1, light=True, defer=True)
    assert isinstance(res, T.SweepResult) and res.okq.dtype == torch.bool
    okq = res.okq.numpy()
    assert not okq.all()
    copies = []

    def counting_fetch(*ts):
        copies.append(len(ts))
        return T.fetch(*ts)

    d, i, tier = res.escalate(okq, counting_fetch)
    assert tier == 2 and copies == [2]               # the exact scan's (dist, idx), once
    assert d.shape == i.shape == (8, 10) and i.dtype == np.int32


# ------------------------------------------------------------------ engine


@pytest.fixture
def sweep_pair():
    rng = np.random.default_rng(2024)
    n = 20_000
    x = rng.standard_normal((n, D), dtype=np.float32)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, n)]
    jqp = JaxQueryProcessor(config=JaxConfig())
    tqp = QueryProcessor(SWEEP, device="cpu")
    jqp.bulk_load(x, "ns", ids=ids)
    tqp.bulk_load(x, "ns", ids=ids)
    return rng, x, ids, jqp, tqp


def _search_both(jqp, tqp, queries, k, metric):
    jr = jqp.find_similar_batch([JaxDTO(v) for v in queries], k, "ns", metric)
    tr = tqp.find_similar_batch([VectorDTO(v) for v in queries], k, "ns", metric)
    for a, b in zip(jr, tr):
        assert {r["id"] for r in a} == {r["id"] for r in b}
        np.testing.assert_allclose(sorted(r["score"] for r in b),
                                   sorted(r["score"] for r in a), rtol=1e-4, atol=1e-4)
    return tr


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_engine_sweep_exact_before_and_after_deletes(sweep_pair, metric):
    rng, x, ids, jqp, tqp = sweep_pair
    ns = tqp.storage.namespace("ns")
    assert ns.capacity == 32768 and ns._mirror.dtype == torch.bfloat16
    queries = rng.standard_normal((16, D), dtype=np.float32)
    before = dict(tqp.transfer_counts)
    tr = _search_both(jqp, tqp, queries, 10, metric)
    assert (tqp.transfer_counts["h2d"] - before["h2d"],
            tqp.transfer_counts["d2h"] - before["d2h"]) == (1, 1)
    assert all(len(r) == 10 for r in tr)
    assert tqp.cert_tier_counts("ns") == {"light_fast": 1}
    gone = [ids[i] for i in rng.choice(len(ids), 300, replace=False)]
    gone += [r["id"] for r in tr[0][:3]]          # and query 0's three best
    assert sorted(map(str, jqp.delete(gone, "ns"))) == sorted(map(str, tqp.delete(gone, "ns")))
    state = ns.device_state()
    assert state.live_count < state.high_water and state.prep_cache == {}
    tr = _search_both(jqp, tqp, queries, 10, metric)
    assert not {r["id"] for rs in tr for r in rs} & set(gone)
    assert tqp.cert_tier_counts("ns") == {"light_fast": 2}


def test_engine_clustered_namespace_flips_to_heavy(monkeypatch):
    _, x, queries = _clustered(81, 30_000, 8, 8, 0.05, 1e-3)
    tqp = QueryProcessor(SWEEP, device="cpu")
    tqp.bulk_load(x, "c")
    calls = []
    real = T._window_mins_t

    def spy(qh, qres, mirror, resid, *a, **kw):
        calls.append("heavy" if qres is not None and resid is not None else "light")
        return real(qh, qres, mirror, resid, *a, **kw)

    monkeypatch.setattr(T, "_window_mins_t", spy)
    before = dict(tqp.transfer_counts)
    first = tqp.find_similar_batch([VectorDTO(v) for v in queries], 10, "c", "l2")
    # escalated: the tier-1 copy, then the exact scan's result (no tier 2 at this size)
    assert (tqp.transfer_counts["h2d"] - before["h2d"],
            tqp.transfer_counts["d2h"] - before["d2h"]) == (1, 2)
    assert tqp.cert_tier_counts("c") == {"light_exact_scan": 1}
    assert tqp._cert_mode == {("c", "l2", False): "heavy"}
    second = tqp.find_similar_batch([VectorDTO(v) for v in queries + np.float32(1e-4)], 10,
                                    "c", "l2")
    assert calls == ["light", "heavy"]
    counts = tqp.cert_tier_counts("c")
    heavy = {name: n for name, n in counts.items() if not name.startswith("light_")}
    assert counts["light_exact_scan"] == 1 and sum(heavy.values()) == 1
    for res, qs in ((first, queries), (second, queries + np.float32(1e-4))):
        d64 = ((qs.astype(np.float64)[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        want = np.sort(d64, axis=1)[:, :10]
        got = np.array([[r["score"] for r in rs] for rs in res])
        np.testing.assert_allclose(np.sort(got, 1), want, rtol=1e-4, atol=1e-5)


def test_backend_sweep_return_contract():
    _, db, q = _gaussian(91, 2 * TILE, 8)
    n = 2 * TILE
    z, s, e2, e1 = T.quantize_resid_rows(_t(db))
    backend = knn_backend(SWEEP)
    kw = dict(k=5, metric="l2", db_tile=8192, live_prefix=n, mirror=_t(db).to(torch.bfloat16),
              sweep_err=e2, sweep_resid=z, sweep_rscale=s, sweep_err1=e1, sweep_light=True)
    args = (_t(q), _t(db), torch.ones(n, dtype=torch.bool), _t((db * db).sum(-1)))
    d, i = backend(*args, **kw)
    d3, i3, tier = backend(*args, report_tier=True, **kw)
    assert tier == 0 and torch.equal(i, i3) and torch.equal(d, d3)
    assert isinstance(backend(*args, sweep_defer=True, **kw), T.SweepResult)


def test_store_keeps_sweep_arrays_in_step():
    rng = np.random.default_rng(92)
    tqp = QueryProcessor(SWEEP, device="cpu")
    ids = tqp.bulk_load(rng.standard_normal((3000, D), dtype=np.float32), "s")
    ns = tqp.storage.namespace("s")
    assert ns.capacity == 4096 and ns._mirror is not None
    # growth past the first capacity, an overwrite and a compaction keep every array equal
    # to what the rows give
    ids += tqp.bulk_load(rng.standard_normal((3000, D), dtype=np.float32), "s")
    tqp.upsert_many([VectorDTO(rng.standard_normal(D).astype(np.float32), id=ids[7])], "s")
    assert ns.capacity == 8192
    tqp.delete(ids[:2000], "s")                    # above the 0.2 ratio: compaction
    assert ns.capacity == 4096 and ns._tombstones == 0
    for label in ("after compaction",):
        z, s, e2, e1 = T.quantize_resid_rows(ns._data)
        assert torch.equal(ns._mirror, ns._data.to(torch.bfloat16)), label
        assert torch.equal(ns._sweep_resid, z) and torch.equal(ns._sweep_rscale, s)
        assert torch.equal(ns._sweep_err, e2) and torch.equal(ns._sweep_err1, e1)
    assert ns.nbytes == 4096 * (D * 4 + 5) + 4096 * (D * 2 + D + 3 * 4)
    plain = QueryProcessor(EngineConfig(sweep_resid=False, sweep_dtype="bfloat16"),
                           device="cpu")
    plain.bulk_load(rng.standard_normal((100, D), dtype=np.float32), "p")
    pns = plain.storage.namespace("p")
    assert pns._sweep_resid is None
    assert torch.equal(pns._sweep_err, T.sweep_err_norms(pns._data))


def test_carry_over_from_jax_sweep_store():
    rng = np.random.default_rng(93)
    x = rng.standard_normal((9000, D), dtype=np.float32) * 2.0
    jns = JaxNamespaceStore("w", JaxConfig(sweep_dtype="bfloat16"))
    jns.bulk_upsert(x, [uuid.UUID(int=i + 1) for i in range(len(x))])
    tns = convert.store_from_jax_snapshot(jns.snapshot_arrays(), SWEEP, "cpu")
    assert tns.capacity == jns.capacity == 16384
    carried = convert.sweep_arrays_from_jax(
        np.asarray(jns._data_t), np.asarray(jns._sweep_resid), np.asarray(jns._sweep_err),
        np.asarray(jns._sweep_rscale), np.asarray(jns._sweep_err1), device="cpu")
    assert torch.equal(carried["mirror"].view(torch.int16), tns._mirror.view(torch.int16))
    assert torch.equal(carried["sweep_resid"], tns._sweep_resid)
    # the JAX store's jitted upkeep computes the scale as max|delta| * (1/127), where
    # the eager quantizer (and the port) divides: at most 1 ulp apart
    np.testing.assert_allclose(carried["sweep_rscale"].numpy(), tns._sweep_rscale.numpy(),
                               rtol=2.0 ** -23, atol=0)
    # the norms: another summation order (sqrt(Dp) ulps), and for ||delta - scale*z|| the
    # scale's ulp times ||z||
    zn = torch.linalg.vector_norm(tns._sweep_resid.float(), dim=1).numpy()
    for name, atol in (("sweep_err", 2.0 ** -23 * tns._sweep_rscale.numpy() * zn),
                       ("sweep_err1", 0.0)):
        got, want = carried[name].numpy(), getattr(tns, f"_{name}").numpy()
        assert (np.abs(got - want) <= np.sqrt(D) * 2.0 ** -23 * want + atol).all(), name
    # and the converted store searches as the JAX store does
    q = rng.standard_normal((8, D), dtype=np.float32)
    st = jns.device_state()
    jd, ji, jt = J.exact_knn_pallas_t(
        jnp.asarray(q), st.data_t, st.data, st.valid, st.sq_norms, k=10, metric="l2",
        live_prefix=st.high_water, sweep_err=st.sweep_err, resid=st.sweep_resid,
        rscale=st.sweep_rscale, err1=st.sweep_err1, light=True, report_tier=True)
    ts = tns.device_state()
    td, ti, tt = T.exact_knn_t(
        _t(q), ts.mirror, ts.data, ts.valid, ts.sq_norms, k=10, metric="l2",
        live_prefix=ts.high_water, sweep_err=ts.sweep_err, resid=ts.sweep_resid,
        rscale=ts.sweep_rscale, err1=ts.sweep_err1, light=True, report_tier=True)
    assert tt == int(jt) == 0
    for b in range(8):
        assert set(ti[b].tolist()) == set(np.asarray(ji)[b].tolist())
    np.testing.assert_allclose(np.sort(td.numpy(), 1), np.sort(np.asarray(jd), 1),
                               rtol=1e-5, atol=1e-5)
