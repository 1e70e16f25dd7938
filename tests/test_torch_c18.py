"""ROADMAP C18: the float64 settle of every f32 top-k boundary, on the CPU.

Every exact path ends in a top-k over f32 distances, and the l2 expansion's f32 error
scales with |q|^2 + |x|^2, not with the distance.  The JAX package returns the f32 order;
the port orders the boundary by float64 (``ops/settle.py``) and returns fl32 of the
float64 distances.  Held here against the JAX package (its Pallas kernels in interpret
mode), with inputs made from a seed with numpy:

  * ``f32_band`` against float64 over thousands of rows offset from the origin, at
    Dp = 128 and 1536: no f32 value of the port's formulas (B2's plain version with the
    rescan's formula, the scan's product, a shuffled summation) strays beyond it;
  * pairs q + e, q - e (e orthogonal to q) that the plain f32 formula orders strictly
    against float64, through the certified rescan, the row-major path, the scan and the
    sharded merge, l2 and cosine: JAX's output in its f32 order, the port's in float64
    order, the two differing on the pairs JAX's f32 sums reverse;
  * the flag: more than ``spare`` candidates within the band of the k-th, settled again
    wider, give the float64 oracle's set and order at the JAX package's tier, in one more
    counted copy; the scan settles such a query over every row within the band;
  * ROADMAP C19: the certificate's margin covers every f32 term of its inequality,
    which the JAX package's slack alone does not at l2 for a query small beside the rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlvectordb_tpu.ops import pallas_knn as JF
from mlvectordb_tpu.ops import pallas_knn_t as J
from mlvectordb_tpu.ops import topk as JK
from mlvectordb_tpu.parallel import ShardingManager as JShardingManager
from mlvectordb_tpu.parallel import build_mesh as jbuild_mesh
from mlvectordb_tpu_torch.ops import fused_knn as F
from mlvectordb_tpu_torch.ops import fused_knn_t as T
from mlvectordb_tpu_torch.ops import settle as S
from mlvectordb_tpu_torch.ops import topk as TK
from mlvectordb_tpu_torch.ops.distances import pairwise_distances
from mlvectordb_tpu_torch.parallel import ShardingManager, build_mesh

D = 128
CPU8 = [torch.device("cpu")] * 8


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _f32(q, x, metric):
    """The plain f32 formula of one (query, row) pair, every step rounded to f32."""
    f = np.float32
    q, x = q.astype(f), x.astype(f)
    qn, sqn, dot = f(q @ q), f(x @ x), f(q @ x)
    if metric == "l2":
        return max(f(f(qn + sqn) - f(2) * dot), f(0))
    return f(f(1) - dot * f(f(1) / np.sqrt(f(qn * sqn))))


def _f64(q, x, metric):
    q, x = q.astype(np.float64), x.astype(np.float64)
    if metric == "l2":
        return ((x - q) ** 2).sum()
    return 1 - x @ q / np.sqrt((x @ x) * (q @ q))


def _pairs(metric, B, cap, slots, seed=18):
    """B queries, each with a pair q + e, q - e (e orthogonal to q, so equal distances in
    exact arithmetic) that the plain f32 formula orders strictly against float64; every
    other row gaussian offset by 20.  ``slots(b)``: the pair's two slots.  Returns (db,
    q, pairs, float64 distances [B, 2])."""
    rng = np.random.default_rng(seed + len(metric))
    db = (rng.standard_normal((cap, D)) + 20).astype(np.float32)
    qs, pairs, d64 = [], [], []
    while len(qs) < B:
        q = rng.standard_normal(D).astype(np.float32)
        e = rng.standard_normal(D) * 0.1
        e -= (e @ q) / (q.astype(np.float64) @ q) * q
        a, c = (q + e).astype(np.float32), (q - e).astype(np.float32)
        fa, fc = _f32(q, a, metric), _f32(q, c, metric)
        da, dc = _f64(q, a, metric), _f64(q, c, metric)
        if da == dc or (fa - fc) * (da - dc) >= 0:
            continue                       # keep only pairs f32 orders strictly wrong
        lo, hi = slots(len(qs))
        db[lo], db[hi] = a, c
        qs.append(q)
        pairs.append((lo, hi))
        d64.append((da, dc))
    return db, np.stack(qs), pairs, np.array(d64)


def _check_orders(pairs, d64, ji, jd, ti, td, *, min_reversed):
    """Both packages return each pair as the query's two nearest; the port in float64
    order, JAX in the order of its own f32 distances; JAX reverses at least
    ``min_reversed`` pairs against float64, and there the two packages differ."""
    reversed_ = 0
    for b, pair in enumerate(pairs):
        want = list(pair if d64[b, 0] < d64[b, 1] else pair[::-1])
        assert sorted(ji[b, :2].tolist()) == sorted(ti[b, :2].tolist()) == sorted(pair), b
        assert ti[b, :2].tolist() == want, b                   # the port: float64
        assert td[b, 0] <= td[b, 1], b
        assert jd[b, 0] <= jd[b, 1], b                         # JAX: its f32 values
        if ji[b, :2].tolist() != want:
            reversed_ += 1
            assert jd[b, 0] <= jd[b, 1] and ji[b, :2].tolist() != ti[b, :2].tolist()
    assert reversed_ >= min_reversed, reversed_


def _premise(q, db, pairs, d64, metric):
    """The construction's premise: the plain f32 formula orders every pair against
    float64."""
    for b, (lo, hi) in enumerate(pairs):
        f = _f32(q[b], db[lo], metric) - _f32(q[b], db[hi], metric)
        assert f * (d64[b, 0] - d64[b, 1]) < 0, b


# ------------------------------------------------------------------ the band


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("dp,n", [(128, 8192), (1536, 4096)])
def test_f32_band_bounds_every_formula(dp, n, metric):
    """No f32 value of the port's formulas strays from float64 beyond ``f32_band``: the
    rescan's (B2's plain version, then qn + sqn - 2 q.x), the scan's (one f32 product),
    and a summation in shuffled order, over rows offset by 20 and queries both near
    them and at the origin."""
    rng = np.random.default_rng(dp + len(metric))
    db = (rng.standard_normal((n, dp)) + 20).astype(np.float32)
    q = np.concatenate([rng.standard_normal((4, dp)) + 20, rng.standard_normal((4, dp))])
    q = q.astype(np.float32)
    q32, x = _t(q), _t(db)
    qn = (q32 * q32).sum(-1)
    sqn = (x * x).sum(-1)
    want = torch.cat([S.value64(q32[b:b + 1].double()[:, None, :], x.double()[None],
                                qn[b:b + 1].double()[:, None], metric) for b in range(8)])
    band = S.f32_band(metric, qn[:, None], sqn[None, :], dp)
    # the rescan: B2's plain version over every row in windows of 8
    r1 = 8
    f = torch.arange(n // r1, dtype=torch.int32)[None].expand(8, -1).contiguous()
    dots, sqn_c = T._gather_score(q32, x, f, r1=r1)
    if metric == "l2":
        rescan = torch.clamp_min(qn[:, None] + sqn_c - 2.0 * dots, 0.0)
    elif metric == "ip":
        rescan = 1.0 - dots
    else:
        rescan = 1.0 - dots * torch.rsqrt(torch.clamp_min(qn[:, None] * sqn_c, 1e-30))
    scan = pairwise_distances(q32, x, sqn, qn, metric, round_query=False)
    perm = torch.from_numpy(rng.permutation(dp))
    shuffled = pairwise_distances(q32[:, perm], x[:, perm], sqn, qn, metric, round_query=False)
    for got in (rescan, scan, shuffled):
        err = (got.double() - want).abs()
        assert (err <= band).all(), float((err / band).max())
        assert float((err / band).max()) > 1e-4            # the band is not vacuous


# ------------------------------------------------------------------ the four paths


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_c18_certified_rescan_settles_in_float64(metric):
    """The certified rescan (``_rescan_windows``: B2's plain version, the formula, the
    settle) against JAX's on the same windows, k = 2: the pair comes back in float64
    order from the port, in JAX's f32 order from JAX."""
    r1, cap, k, B = 8, 16384, 2, 64
    db, q, pairs, d64 = _pairs(metric, B, cap,
                               lambda b: (16 + b * 2 * r1, 16 + (b * 2 + 1) * r1 + 3))
    _premise(q, db, pairs, d64, metric)
    f = np.sort(np.stack([[lo // r1, hi // r1, 1500 + b, 1800 + b]
                          for b, (lo, hi) in enumerate(pairs)]).astype(np.int32), 1)
    maskadd = np.zeros(cap, np.float32)
    qn = (q * q).sum(-1, keepdims=True)
    jd, ji = J._rescan_windows(jnp.asarray(q), jnp.asarray(qn), jnp.asarray(db),
                               jnp.asarray(maskadd), cap, jnp.asarray(f), k=k, metric=metric,
                               r1=r1, masked=True)
    td, ti = T._rescan_windows(_t(q), _t(qn), _t(db), _t(maskadd), cap, _t(f), k=k,
                               metric=metric, r1=r1, masked=True)
    _check_orders(pairs, d64, np.asarray(ji), np.asarray(jd), ti.numpy(), td.numpy(),
                  min_reversed=B // 8)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_c18_row_major_rescan_settles_in_float64(metric):
    """The row-major path (``exact_knn_fused``: B5's plain version, selection, rescan)
    against JAX's ``exact_knn_pallas`` (interpret mode), masked, k = 2."""
    cap, B = 2 * F.DB_TILE, 64
    db, q, pairs, d64 = _pairs(metric, B, cap, lambda b: (16 + 40 * b, 3000 + 60 * b + 5))
    _premise(q, db, pairs, d64, metric)
    valid = np.ones(cap, bool)
    valid[-5:] = False
    sq = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    jd, ji = JF.exact_knn_pallas(jnp.asarray(q), jnp.asarray(db), jnp.asarray(valid),
                                 jnp.asarray(sq), k=2, metric=metric, live_prefix=None)
    td, ti = F.exact_knn_fused(_t(q), _t(db), _t(valid), _t(sq), k=2, metric=metric,
                               live_prefix=None)
    _check_orders(pairs, d64, np.asarray(ji), np.asarray(jd), ti.numpy(), td.numpy(),
                  min_reversed=B // 8)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_c18_scan_settles_in_float64(metric):
    """The tiled scan (``exact_knn``, two 8192-row tiles folded) against JAX's, k = 2;
    at k = 1 JAX's answer is the farther row of every pair it reverses (a wrong set),
    the port's the nearer."""
    cap, B = 16384, 64
    db, q, pairs, d64 = _pairs(metric, B, cap, lambda b: (16 + 40 * b, 9000 + 60 * b + 5))
    _premise(q, db, pairs, d64, metric)
    valid = np.ones(cap, bool)
    sq = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    out = {}
    for k in (1, 2):
        jd, ji = JK.exact_knn(jnp.asarray(q), jnp.asarray(db), jnp.asarray(valid),
                              jnp.asarray(sq), k=k, metric=metric, db_tile=8192)
        td, ti = TK.exact_knn(_t(q), _t(db), _t(valid), _t(sq), k=k, metric=metric,
                              db_tile=8192)
        out[k] = np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()
    jd, ji, td, ti = out[2]
    _check_orders(pairs, d64, ji, jd, ti, td, min_reversed=B // 8)
    nearest = np.array([p[int(d[1] < d[0])] for p, d in zip(pairs, d64)])
    assert (out[1][3][:, 0] == nearest).all()
    assert (out[1][1][:, 0] != nearest).sum() >= B // 8


def _sharded_pairs(metric, B=32, c=2048):
    """Pairs whose rows sit in different shards of a (1, 8) mesh of c rows a shard."""
    return _pairs(metric, B, 8 * c, lambda b: (16 + 8 * b, c * (1 + b % 7) + 300 + 8 * b))


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_c18_sharded_merge_orders_by_float64(metric):
    """The sharded merge on the port's ``[cpu] * 8`` mesh against JAX's 8-device CPU
    mesh, each pair's rows in two shards: JAX folds the shards' lists by f32 value, the
    port by each shard's float64 keys."""
    db, q, pairs, d64 = _sharded_pairs(metric)
    _premise(q, db, pairs, d64, metric)
    valid = np.ones(len(db), bool)
    sq = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    jsm = JShardingManager(jbuild_mesh(1, 8))
    data, v, n = jsm.place_database(jnp.asarray(db), jnp.asarray(valid), jnp.asarray(sq))
    jd, ji = jsm.sharded_knn(jnp.asarray(q), data, v, n, k=2, metric=metric)
    sm = ShardingManager(build_mesh(1, 8, devices=CPU8))
    shards = sm.place_database(_t(db), _t(valid), _t(sq))
    td, ti = sm.sharded_knn(_t(q), shards, k=2, metric=metric)
    _check_orders(pairs, d64, np.asarray(ji), np.asarray(jd), ti.numpy(), td.numpy(),
                  min_reversed=len(pairs) // 8)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_c18_sharded_escalation_merges_by_float64_on_the_host(metric):
    """The sharded escalation (every shard's proof read as failed, over a bf16 mirror):
    each shard escalates with its own counted copies, and the host merge orders the
    fetched lists by their float64 keys, as the device merge does."""
    db, q, pairs, d64 = _sharded_pairs(metric, c=8192)
    valid = np.ones(len(db), bool)
    sq = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    sm = ShardingManager(build_mesh(1, 8, devices=CPU8))
    data = _t(db)
    shards = sm.place_database(data, _t(valid), _t(sq), data.to(torch.bfloat16),
                               T.sweep_err_norms(data))
    out = sm.sharded_knn(_t(q), shards, k=2, metric=metric, defer=True)
    assert out.okq is not None and out.okq.shape == (8 * len(q),)
    copies = []

    def counting_fetch(*ts):
        copies.append(len(ts))
        return T.fetch(*ts)

    okq = np.zeros(out.okq.shape, bool)
    need = None if out.need is None else T.fetch(out.need)[0]
    d, i, tier = out.escalate(okq, counting_fetch, need_host=need)
    assert tier >= 1 and len(copies) >= 8
    td, ti = sm.sharded_knn(_t(q), shards, k=2, metric=metric)
    _check_orders(pairs, d64, ti.numpy(), td.numpy(), i, d, min_reversed=0)
    np.testing.assert_array_equal(i, ti.numpy())


# ------------------------------------------------------------------ the flag


def _crowded(seed, B=8, cap=16384, crowd=12):
    """B queries near the rows (offset by 20, so the band is ~1.6 at Dp = 128), each with
    ``crowd`` rows at distance ~1 whose float64 distances differ by ~1e-5: far inside the
    band, so f32 orders them at random and more than kk + spare of them sit in it."""
    rng = np.random.default_rng(seed)
    db = (rng.standard_normal((cap, D)) + 20).astype(np.float32)
    q = (rng.standard_normal((B, D)) + 20).astype(np.float32)
    for b in range(B):
        for j in range(crowd):
            e = rng.standard_normal(D)
            e -= (e @ q[b]) / (q[b].astype(np.float64) @ q[b]) * q[b]
            e *= np.sqrt(1 + j * 1e-5) / np.linalg.norm(e)
            db[97 + b * 1000 + j * 23] = q[b] + e
    return db, q


def _oracle(db, q, k):
    """Each query's k nearest rows by float64 l2, ties by slot."""
    x = db.astype(np.float64)
    d = np.stack([((x - v) ** 2).sum(-1) for v in q.astype(np.float64)])
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def test_c18_flag_settles_the_rescan_wider():
    """``_rescan_settle`` over windows holding a crowd of 12 rows within the band: every
    query is flagged (more than kk + spare candidates in the band) with a width that
    holds them, and ``resolve`` settles it again there into the oracle's order, where the
    narrow settle alone need not."""
    r1, cap, k = 8, 16384, 4
    db, q = _crowded(181, cap=cap)
    oracle = _oracle(db, q, k)
    f = np.sort(np.stack([[(97 + b * 1000 + j * 23) // r1 for j in range(12)] + [1900 + b]
                          for b in range(len(q))]).astype(np.int32), 1)
    qn = (q * q).sum(-1, keepdims=True)
    st = T._rescan_settle(_t(q), _t(qn), _t(db), _t(np.zeros(cap, np.float32)), cap, _t(f),
                          k=k, metric="l2", r1=r1, masked=True)
    need = st.need.numpy()
    assert (need > k + 4).all() and (need <= f.shape[1] * r1).all()
    d, i, key = st.resolve()
    assert (i.numpy() == oracle).all()
    assert (np.diff(d.numpy(), axis=1) >= 0).all()
    _, _, key2 = st.widen(np.arange(len(q)), int(need.max()))
    assert torch.equal(key, key2)


@pytest.mark.parametrize("light", [True, False], ids=["light", "heavy"])
def test_c18_flag_at_the_parent_tier(light):
    """The certified sweep over a bf16 mirror on the crowded corpus: the port's tier is
    the JAX package's, its answers the float64 oracle's in order, and the flagged
    queries cost one more copy when the proof holds (none else)."""
    db, q = _crowded(182)
    n, k = len(db), 4
    valid = np.ones(n, bool)
    sq = (db * db).sum(-1).astype(np.float32)
    z, s, e2, e1 = (np.asarray(x) for x in J.quantize_resid_rows(jnp.asarray(db)))
    _, _, jt = J.exact_knn_pallas_t(
        jnp.asarray(q), J.to_sweep_layout(jnp.asarray(db), dtype=jnp.bfloat16),
        jnp.asarray(db), jnp.asarray(valid), jnp.asarray(sq), k=k, metric="l2",
        live_prefix=n, sweep_err=jnp.asarray(e2), resid=J.to_sweep_layout(jnp.asarray(z)),
        rscale=jnp.asarray(s), err1=jnp.asarray(e1), light=light, report_tier=True)
    res = T.exact_knn_t(_t(q), _t(db).to(torch.bfloat16), _t(db), _t(valid), _t(sq), k=k,
                        metric="l2", live_prefix=n, sweep_err=_t(e2), resid=_t(z),
                        rscale=_t(s), err1=_t(e1), light=light, defer=True)
    copies = []

    def counting_fetch(*ts):
        copies.append(len(ts))
        return T.fetch(*ts)

    host = T.fetch(*res.parts())
    d, i, tier = res.finish(host, counting_fetch)
    assert tier == int(jt)
    assert (i == _oracle(db, q, k)).all()
    assert (np.diff(d, axis=1) >= 0).all()
    if tier == 0:
        assert host[3].any() and copies == [2]      # the wider settle's one copy


@pytest.mark.parametrize("crowd", [12, 40])
def test_c18_scan_flag_settles_over_the_band(monkeypatch, crowd):
    """The scan carries k + 20 at k = 4 and settles k + 4: a crowd within the band of the
    k-th flags every query.  Twelve fit in the carried list, so each query is settled
    again there; forty do not, so each is settled over every row within its band
    (``_band_settle``).  Both give the oracle's set and order."""
    db, q = _crowded(183, crowd=crowd)
    k = 4
    valid = np.ones(len(db), bool)
    sq = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    calls = []
    real = TK._band_settle
    monkeypatch.setattr(TK, "_band_settle", lambda *a, **kw: calls.append(a[1].shape[0])
                        or real(*a, **kw))
    d, i, key = TK.exact_knn(_t(q), _t(db), _t(valid), _t(sq), k=k, metric="l2",
                             db_tile=4096, with_key=True)
    assert calls == ([] if crowd == 12 else [len(q)])
    assert (i.numpy() == _oracle(db, q, k)).all()
    assert (np.diff(key.numpy(), axis=1) >= 0).all()
    np.testing.assert_array_equal(d.numpy(), key.numpy().astype(np.float32))


# ------------------------------------------------------------------ ROADMAP C19


@pytest.mark.parametrize("qnorm", [0.01, 0.1, 10.0])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_c19_margin_bounds_every_f32_term(metric, qnorm):
    """The certificate's margin (``_certify``: ``_fused_t``'s err, the slack Dp 2^-22 |qh|
    maxd, plus ``_rank_terms``) covers every f32 term of its inequality, here over an f32
    mirror, whose err has no mirror term and so is the smallest, at a query norm small
    beside the rows' (|x| ~ 20 sqrt(128)) and one not: for every row y as the k-th and
    every row x that could beat it (at l2 those within y's ball, |x| <= |q| + sqrt(d_y)),
    err >= (x's f32 rank above its exact one) + (y's exact rank above the f32 rank the
    check computes from the settled k-th, fl32 of its float64 distance).
    So thresh - err >= kth_rank gives d(x) >= d(y).  At l2 the slack alone falls short
    of that at the small norms (the bias row's f32 |x|^2 and the kernel's add round at
    u maxd^2), which was ROADMAP C19; JAX's margin is the slack."""
    dp, n = 128, 2048
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.normal(0, 20, (n, dp)).astype(np.float32))
    q = rng.standard_normal(dp)
    q = torch.from_numpy((q / np.linalg.norm(q) * qnorm).astype(np.float32))[None]
    sqn = (x * x).sum(-1)                                       # the store's f32 norms
    prep = T.search_prep(x, torch.ones(n, dtype=torch.bool), sqn, metric=metric,
                         live_prefix=n, rescan_dtype=torch.float32)
    qn = (q * q).sum(-1)
    ql = torch.sqrt(qn)
    maxd = prep["maxd"]
    slack = dp * 2.0 ** -22 * ql * (2 if metric == "l2" else 1) * (1 if metric == "cosine"
                                                                   else maxd)
    qh = T._fold_query(q, metric, False, torch.float32, False)[0]
    rank = (x @ qh.T)[:, 0]                                     # the plain B3 rank, f32
    if prep["scale_row"] is not None:
        rank = rank * prep["scale_row"]
    rank = rank + prep["bias_row"]
    x64, q64 = x.double(), q[0].double()
    dot = x64 @ q64
    norm = torch.sqrt((x64 * x64).sum(-1))
    exact = {"l2": (x64 * x64).sum(-1) - 2 * dot, "ip": -dot, "cosine": -dot / norm}[metric]
    d64 = S.value64(q64[None, None], x64[None], (q64 @ q64)[None, None], metric)[0]
    kth = d64.float()                                           # every row as the k-th
    target = {"l2": d64 - q64 @ q64, "ip": d64 - 1,
              "cosine": (d64 - 1) * torch.sqrt(q64 @ q64)}[metric]
    kth_rank = {"l2": kth - qn, "ip": kth - 1.0, "cosine": (kth - 1.0) * ql}[metric]
    # x's rounding counts where x could beat y at all: at l2 within y's ball,
    # |x| <= |q| + sqrt(d_y) (``_rank_terms``); the rows here all lie near one norm
    over = rank.double() - exact
    if metric == "l2":
        ball = norm[None, :] <= torch.sqrt(q64 @ q64) + torch.sqrt(d64)[:, None]
        over = torch.where(ball, over[None, :], -float("inf")).amax(1)
    else:
        over = over.max()
    need = over + (target - kth_rank.double())
    err = (slack + T._rank_terms(metric, kth, kth_rank, qn, ql, maxd, dp)) * (1 + 2.0 ** -20)
    assert (err.double() >= need).all()
    if metric == "l2" and qnorm < 1:
        assert (slack.double() < need).any()


def test_c19_jax_margin_certifies_a_wrong_set():
    """A wrong set that the JAX package's margin certifies, over an f32 mirror: rows of
    |x|^2 ~ 40,000 (an f32 ulp of 2^-8) orthogonal to a query of norm 0.01, so each row's
    rank is its f32 norm alone, whose rounding reorders rows 4e-7 apart in float64.  Row
    x is the nearest, y the next and z the third, but their f32 norms rank y, z, x: the
    k = 1 selection of two windows takes y's and z's, and JAX's check (thresh = z's rank,
    the slack 1.2e-4 below it, above y's f32 rank) proves y at tier 0.  The port's margin
    carries the bias row's f32 norm (g maxd^2, ROADMAP C19), fails the proof, and returns
    x from tier 1."""
    dp, a, m = 128, 40000.0, 20000
    rng = np.random.default_rng(19)
    g = rng.standard_normal((m, dp - 1))
    g *= np.sqrt(a) / np.linalg.norm(g, axis=1, keepdims=True)
    v = np.zeros((m, dp), np.float32)
    v[:, 1:] = g
    e = (v.astype(np.float64) ** 2).sum(1)
    f = (_t(v) ** 2).sum(-1).numpy().astype(np.float64)     # the store's f32 norms
    ulp = float(np.spacing(np.float32(a)))
    low = np.argsort(e)[:m // 10]
    x = low[np.argmax(f[low] - e[low])]
    ys = np.flatnonzero((e > e[x]) & (f <= f[x] - 2 * ulp))
    y = ys[np.argmin(e[ys])]
    zs = np.flatnonzero((e > e[y]) & (f > f[y]) & (f < f[x]))
    z = zs[np.argmin(e[zs])]
    n = 2 * T.SWEEP_TILE
    far = rng.standard_normal((n, dp - 1))
    db = np.zeros((n, dp), np.float32)
    db[:, 1:] = far * (np.sqrt(a + 1000) / np.linalg.norm(far, axis=1, keepdims=True))
    db[0], db[32], db[64] = v[y], v[z], v[x]                   # windows 0, 1 and 2
    sq = (_t(db) ** 2).sum(-1).numpy()
    q = np.zeros((1, dp), np.float32)
    q[0, 0] = 0.01
    valid = np.ones(n, bool)
    d64 = ((db.astype(np.float64) - q) ** 2).sum(1)
    assert np.argmin(d64) == 64 and d64[64] < d64[0] < d64[32]
    _, ji, jt = J.exact_knn_pallas_t(
        jnp.asarray(q), J.to_sweep_layout(jnp.asarray(db), dtype=jnp.float32),
        jnp.asarray(db), jnp.asarray(valid), jnp.asarray(sq), k=1, metric="l2",
        live_prefix=n, report_tier=True)
    _, ti, tt = T.exact_knn_t(_t(q), _t(db), _t(db), _t(valid), _t(sq), k=1, metric="l2",
                              live_prefix=n, report_tier=True)
    assert (np.asarray(ji).tolist(), int(jt)) == ([[0]], 0)     # JAX: y, proven
    assert (ti.tolist(), tt) == ([[64]], 1)                     # the port: x, tier 1
