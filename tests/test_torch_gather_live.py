"""The rescan kernel B2 on the live query rows only (``_gather_score(..., n_live=n)``), on
the CPU.

The engine pads a batch of B queries with zero rows up to its bucket.  Phase 1 gives
every padded row one cached zero-query column, so the padded rows select the same
windows; B2 then computes the live rows and the first padded row, and gives that row's
outputs to the rest (the plain version copies them, the kernel writes them).  The plain
version refuses padding that is not zero queries over one row's windows, and the rescan
gives every padded row the first padded row's windows.  Held here, with the kernels' plain versions and the JAX
package on the CPU (its Pallas kernels in interpret mode):

  * ``_gather_score(n_live=n)`` bit-equal to the full call at B = 256, over f32 and bf16
    rows, padded rows built as the engine builds them (zero queries, copies of one
    window row);
  * the port's rescan with the live count against the JAX package's ``_rescan_windows``
    on the padded batch: the same ids, distances within 1e-4 relative + 1e-5;
  * ``exact_knn_t(n_live=b)`` against ``n_live=None``: every row's distances, the live
    rows' ids, the per-query proof and the tier the same, over the bf16 (light and
    heavy), int8, f32 and same-dtype bf16 mirrors, l2, ip and cosine, k = 10 and 100, and
    the k = 100 pool program;
  * an escalation: the contained one, which re-proves a subset of the rows, computes
    every row of it (no live count); the widened tier 2 of the whole batch gets the
    live count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlvectordb_tpu.ops import pallas_knn_t as J
from mlvectordb_tpu_torch.ops import fused_knn as F
from mlvectordb_tpu_torch.ops import fused_knn_t as T
from mlvectordb_tpu_torch.ops.distances import MASKED

D = 128
TILE = T.SWEEP_TILE
BATCH = 16


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _bits_equal(got, want):
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _padded_windows(rng, n_live, B, n_windows, s1):
    """Sorted window ids [B, s1]: live rows at random (repeats and out-of-range ids
    included, which the kernel clamps), padded rows copies of one row."""
    f = np.sort(rng.integers(-3, n_windows + 3, (B, s1)), axis=1).astype(np.int32)
    if n_live < B:
        f[n_live:] = f[n_live]
    return f


@pytest.mark.parametrize("n", [1, 5, 64, 127, 128, 200])
@pytest.mark.parametrize("rows", [torch.float32, torch.bfloat16])
def test_live_rows_bit_equal_to_full_call(rows, n):
    rng = np.random.default_rng(n + (rows == torch.bfloat16))
    B, s1, r1, cap = 256, 20, 4, 8192
    data = _t(rng.standard_normal((cap, D), dtype=np.float32)).to(rows)
    q = torch.zeros((B, D))
    q[:n] = _t(rng.standard_normal((n, D), dtype=np.float32))
    f = _t(_padded_windows(rng, n, B, cap // r1, s1))
    got = T._gather_score(q, data, f, r1=r1, n_live=n)
    want = T._gather_score(q, data, f, r1=r1)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (B, s1 * r1)
        _bits_equal(g, w)
    assert T._gather_rows(B, n) == n + 1
    assert T._gather_rows(B, None) == T._gather_rows(B, B) == T._gather_rows(B, 300) == B
    assert T._gather_score.launches == T._gather_score.rows == 0   # no kernel on the CPU


@pytest.mark.parametrize("fault", ["query", "windows"])
def test_plain_version_refuses_padding_it_cannot_copy(fault):
    """Rows from n_live on are copies of the first padded row only where they are zero
    queries over that row's windows: the plain version raises on other padding, and
    takes it when every row is computed."""
    rng = np.random.default_rng(3)
    B, n, s1, r1, cap = 16, 5, 6, 4, 1024
    data = _t(rng.standard_normal((cap, D), dtype=np.float32))
    q = torch.zeros((B, D))
    q[:n] = _t(rng.standard_normal((n, D), dtype=np.float32))
    f = _t(_padded_windows(rng, n, B, cap // r1, s1))
    if fault == "query":
        q[B - 1, 0] = 1.0
    else:
        f[B - 1, 0] += 1
    with pytest.raises(ValueError, match="zero queries"):
        T._gather_score(q, data, f, r1=r1, n_live=n)
    dots, _ = T._gather_score(q, data, f, r1=r1)
    assert dots.shape == (B, s1 * r1)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_rescan_gives_every_padded_row_the_first_padded_rows_windows(metric):
    """Padded rows whose selected windows differ (as ties may make them) all take row
    n_live's windows in the rescan, so each one's ids and distances come from the same
    windows: the result equals a rescan of windows that were copies to begin with."""
    rng = np.random.default_rng(11 + len(metric))
    B, n, s1, r1, cap, k = 32, 7, 10, 4, 4096, 10
    db = _t(rng.standard_normal((cap, D), dtype=np.float32))
    q = torch.zeros((B, D))
    q[:n] = _t(rng.standard_normal((n, D), dtype=np.float32))
    qn = (q * q).sum(-1, keepdim=True)
    f = _t(rng.integers(0, cap // r1, (B, s1)).astype(np.int32))
    copied = f.clone()
    copied[n + 1:] = f[n]
    maskadd = torch.zeros(cap)
    got = T._rescan_windows(q, qn, db, maskadd, cap, f, k=k, metric=metric, r1=r1,
                            masked=True, n_live=n)
    want = T._rescan_windows(q, qn, db, maskadd, cap, copied, k=k, metric=metric, r1=r1,
                             masked=True)
    _bits_equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("rows", [torch.float32, torch.bfloat16])
def test_live_rescan_matches_jax(rows, metric):
    """The port's rescan on the live rows and the first padded one against the JAX
    package's ``_rescan_windows`` (XLA, every row) on the padded batch, tombstones
    masked: the same ids, distances within 1e-4 relative + 1e-5."""
    rng = np.random.default_rng(7 + len(metric))
    B, n, s1, r1, cap, k = 64, 13, 24, 8, 16384, 10
    db = rng.standard_normal((cap, D), dtype=np.float32)
    if rows == torch.bfloat16:
        db = _t(db).to(torch.bfloat16).float().numpy()      # the rows JAX reads, exactly
    q = np.zeros((B, D), np.float32)
    q[:n] = rng.standard_normal((n, D), dtype=np.float32)
    f = np.clip(_padded_windows(rng, n, B, cap // r1, s1), 0, cap // r1 - 1)
    valid = rng.random(cap) > 0.05
    maskadd = np.where(valid, 0.0, MASKED).astype(np.float32)
    qn = (q * q).sum(-1, keepdims=True)
    jd, ji = J._rescan_windows(jnp.asarray(q), jnp.asarray(qn), jnp.asarray(db),
                               jnp.asarray(maskadd), cap, jnp.asarray(f), k=k, metric=metric,
                               r1=r1, masked=True)
    td, ti = T._rescan_windows(_t(q), _t(qn), _t(db).to(rows), _t(maskadd), cap, _t(f), k=k,
                               metric=metric, r1=r1, masked=True, n_live=n)
    jd, ji = np.asarray(jd), np.asarray(ji)
    for b in range(n):   # padded rows tie (every candidate 1.0 for ip and cosine)
        assert set(ti[b].tolist()) == set(ji[b].tolist()), b
    np.testing.assert_allclose(np.sort(td.numpy(), 1), np.sort(jd, 1), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ exact_knn_t


def _sweep_args(program, db, valid):
    """(mirror, rescan rows, sq_norms, keyword arrays, light) of one sweep program over
    the rows ``db`` [n, D] f32, as the store builds them."""
    x = _t(db)
    if program in ("light", "heavy"):
        z, s, e2, e1 = T.quantize_resid_rows(x)
        return (x.to(torch.bfloat16), x, (x * x).sum(-1),
                dict(sweep_err=e2, resid=z, rscale=s, err1=e1), program == "light")
    if program == "int8":
        z1, s1, z2, s2, e2, e1 = T.quantize_int8_resid_rows(x)
        return z1, x, (x * x).sum(-1), dict(sweep_err=e2, resid=z2, rscale=s1, err1=e1,
                                             rscale2=s2), False
    if program == "f32":
        return x, x, (x * x).sum(-1), {}, False
    rows = x.to(torch.bfloat16)                               # same_dtype: the rows alone
    return rows, rows, (rows.float() ** 2).sum(-1), {}, False


def _search(q, program, db, valid, *, metric, k, n_live):
    mirror, rescan, sq, arrays, light = _sweep_args(program, db, valid)
    return T.exact_knn_t(q, mirror, rescan, _t(valid), sq, k=k, metric=metric,
                         live_prefix=None, light=light, defer=True, n_live=n_live, **arrays)


def _same_result(live, full, n):
    """Every row's distances and the proof bit-equal, the live rows' ids equal, the tier
    equal; after the proof is read (escalation included), the same again."""
    _bits_equal(live.dist, full.dist)
    assert torch.equal(live.idx[:n], full.idx[:n])
    assert live.tier == full.tier
    assert (live.okq is None) == (full.okq is None)
    if full.okq is not None:
        assert torch.equal(live.okq, full.okq)
    (ld, li, lt), (fd, fi, ft) = live.resolve(), full.resolve()
    _bits_equal(ld, fd)
    assert torch.equal(li[:n], fi[:n]) and lt == ft


class _Spy:
    """Records (rows of f, n_live) of every ``_gather_score`` call."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = T._gather_score

        def spy(q32, data, f, *, r1, n_live=None):
            self.calls.append((f.shape[0], n_live))
            return real(q32, data, f, r1=r1, n_live=n_live)

        monkeypatch.setattr(T, "_gather_score", spy)


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("program", ["light", "heavy", "int8", "f32", "same_dtype"])
def test_live_count_gives_the_same_sweep_result(monkeypatch, program, metric, k):
    rng = np.random.default_rng(len(program) * 10 + k + len(metric))
    n, n_live = 4 * TILE, 5
    db = rng.standard_normal((n, D), dtype=np.float32)
    valid = rng.random(n) > 0.01
    q = torch.zeros((BATCH, D))
    q[:n_live] = _t(rng.standard_normal((n_live, D), dtype=np.float32))
    spy = _Spy(monkeypatch)
    live = _search(q, program, db, valid, metric=metric, k=k, n_live=n_live)
    assert spy.calls[0] == (BATCH, n_live)
    full = _search(q, program, db, valid, metric=metric, k=k, n_live=None)
    _same_result(live, full, n_live)
    # every rescan with the live count saw the whole batch; no other got one
    assert all(b == BATCH for b, nl in spy.calls if nl is not None)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_live_count_with_the_pool_program(monkeypatch, metric):
    """k = 100 over 32 tiles: tier 1 comes from the sweep kernel's per-tile pool
    (``_select_topm_and_rescan``), which hands the live count to the rescan."""
    rng = np.random.default_rng(90 + len(metric))
    n, n_live = 32 * TILE, 3
    db = rng.standard_normal((n, D), dtype=np.float32)
    valid = rng.random(n) > 0.01
    q = torch.zeros((8, D))
    q[:n_live] = _t(rng.standard_normal((n_live, D), dtype=np.float32))
    pools = []
    real = T._select_topm_and_rescan
    monkeypatch.setattr(T, "_select_topm_and_rescan",
                        lambda *a, **kw: pools.append(kw["n_live"]) or real(*a, **kw))
    live = _search(q, "light", db, valid, metric=metric, k=100, n_live=n_live)
    assert pools == [n_live]
    full = _search(q, "light", db, valid, metric=metric, k=100, n_live=None)
    _same_result(live, full, n_live)


@pytest.mark.parametrize("batch", [BATCH, T.FQ_CONTAIN])
def test_escalation_rescans_with_the_live_count_only_on_the_whole_batch(monkeypatch, batch):
    """One live query aims at a tight far-away cluster that the light band cannot
    separate, so its proof fails.  With 16 queries the contained escalation re-proves an
    8-query subset at the tier-2 width: that rescan gets no live count (its rows are a
    subset, not the padded batch).  With 8 the whole batch is re-selected at the tier-2
    width, and that rescan gets it.  Either way the result is the one without it."""
    n, n_live = 20 * TILE, batch - 4
    rng = np.random.default_rng(41)
    db = rng.standard_normal((n, D), dtype=np.float32)
    centre = np.full(D, 4.0, np.float32)
    db[1000:1800] = centre + rng.standard_normal((800, D)).astype(np.float32) * 1e-3
    q = torch.zeros((batch, D))
    q[:n_live] = _t(rng.standard_normal((n_live, D), dtype=np.float32))
    q[0] = _t(centre + rng.standard_normal(D).astype(np.float32) * 1e-3)
    valid = np.ones(n, bool)
    spy = _Spy(monkeypatch)
    live = _search(q, "light", db, valid, metric="l2", k=10, n_live=n_live)
    full = _search(q, "light", db, valid, metric="l2", k=10, n_live=None)
    assert not bool(live.okq[0]) and bool(live.okq[1:].all())
    _same_result(live, full, n_live)
    tier2 = (T.FQ_CONTAIN, None) if batch > T.FQ_CONTAIN else (batch, n_live)
    assert spy.calls == [(batch, n_live), (batch, None), tier2, (tier2[0], None)]
    assert live.resolve()[2] == 1                      # no exact scan


# ------------------------------------------------------------------ ROADMAP C4


def _c4_pairs(metric, B=64, r1=8, cap=16384):
    """One pair of candidates per query, each in windows of its own, the rest far rows.
    Queries 0-15: q + e and q - e with e orthogonal to q in small dyadic values, whose
    distances are equal in exact arithmetic and computed exactly.  Queries 16-63 the same
    with gaussian rows, whose float64 distances differ by less than an ulp of the f32 one
    (those that f32 rounding moved apart are left out).  Returns (db, q, pairs, float64
    distances of each pair)."""
    rng = np.random.default_rng(4)
    db = (rng.standard_normal((cap, D)) + 20).astype(np.float32)
    q = np.zeros((B, D), np.float32)
    pairs = []
    for b in range(B):
        if b < 16:      # e on the query's zero half
            q[b, : D // 2] = rng.integers(-32, 32, D // 2) / 8.0
            e = np.concatenate([np.zeros(D // 2), rng.choice([-0.125, 0.125], D // 2)])
        else:
            q[b] = rng.standard_normal(D)
            e = rng.standard_normal(D) * 0.1
            e -= (e @ q[b]) / (q[b].astype(np.float64) @ q[b]) * q[b]
        lo, hi = 16 + b * 2 * r1, 16 + (b * 2 + 1) * r1 + 3
        db[lo], db[hi] = q[b] + e, q[b] - e
        pairs.append((lo, hi))
    q64, x64 = q.astype(np.float64), db.astype(np.float64)
    d64 = []
    for b, pair in enumerate(pairs):
        a, c = (x64[r] for r in pair)
        if metric == "l2":
            d64.append([((v - q64[b]) ** 2).sum() for v in (a, c)])
        else:
            d64.append([1 - v @ q64[b] / np.sqrt((v @ v) * (q64[b] @ q64[b])) for v in (a, c)])
    return db, q, pairs, np.array(d64)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_c4_sub_ulp_pairs_in_the_rescan(metric):
    """ROADMAP C4: two candidates less than one f32 ulp apart in the certified rescan.  The
    f32 sums decide their order in both packages (a shared exposure: each package sums
    in its own order, B2 in its one-warp-a-row predecessor's).  Where a package computes
    the two the same f32 distance, the JAX package returns the lower slot first
    (``lax.top_k``) and the port
    the row nearer in float64 (``settled_topk``), the lower slot on an exact tie: the
    exact pairs come back in slot order from both, and among the gaussian pairs both
    packages tie on, the port's order is the float64 one and differs from JAX's on some
    (an intended divergence; both asserted)."""
    r1, cap, k = 8, 16384, 4
    db, q, pairs, d64 = _c4_pairs(metric)
    B = len(q)
    f = np.sort(np.stack([[lo // r1, hi // r1, 1500 + b, 1800 + b]
                          for b, (lo, hi) in enumerate(pairs)]).astype(np.int32), 1)
    maskadd = np.zeros(cap, np.float32)
    qn = (q * q).sum(-1, keepdims=True)
    jd, ji = J._rescan_windows(jnp.asarray(q), jnp.asarray(qn), jnp.asarray(db),
                               jnp.asarray(maskadd), cap, jnp.asarray(f), k=k, metric=metric,
                               r1=r1, masked=True)
    td, ti = T._rescan_windows(_t(q), _t(qn), _t(db), _t(maskadd), cap, _t(f), k=k,
                               metric=metric, r1=r1, masked=True)
    jd, ji, td, ti = np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()
    near = ties = differ = 0
    for b, pair in enumerate(pairs):
        assert sorted(ji[b, :2].tolist()) == sorted(ti[b, :2].tolist()) == list(pair), b
        if abs(d64[b, 0] - d64[b, 1]) >= np.spacing(np.float32(d64[b, 0])):
            assert b >= 16, b       # f32 rounding of q +- e moved a gaussian pair apart
            continue
        near += 1
        if td[b, 0] == td[b, 1]:    # the port's tie: the float64 order, then the slot
            assert ti[b, :2].tolist() == list(pair if d64[b, 0] <= d64[b, 1] else pair[::-1]), b
        if jd[b, 0] == jd[b, 1]:    # JAX's tie: the slot order
            assert ji[b, :2].tolist() == list(pair), b
        if td[b, 0] == td[b, 1] and jd[b, 0] == jd[b, 1]:
            ties += 1
            differ += ji[b, :2].tolist() != ti[b, :2].tolist()
        elif b < 16:
            raise AssertionError(f"query {b}: an exact pair computed apart")
    assert near >= 40 and ties >= 17 and differ >= 1


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_c4_row_major_rescan_settles_ties_in_float64(metric):
    """C4 on the row-major path (``exact_knn_fused``, the masked kernel B5's plain version
    and its rescan): each query's pair are its two nearest rows; where the f32 rescan
    gives them the same distance and float64 does not, the row nearer in float64 comes
    first, so k = 1 returns it (rows tied in float64 too go by row, as the rescan hands
    its candidates to the settle in row order, ROADMAP C20)."""
    db, q, pairs, d64 = _c4_pairs(metric, cap=32768)
    valid = np.ones(len(db), bool)
    valid[-5:] = False                                        # the masked kernel
    sq = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    td, ti = F.exact_knn_fused(_t(q), _t(db), _t(valid), _t(sq), k=2, metric=metric,
                               live_prefix=None)
    d1, i1 = F.exact_knn_fused(_t(q), _t(db), _t(valid), _t(sq), k=1, metric=metric,
                               live_prefix=None)
    td, ti, i1 = td.numpy(), ti.numpy(), i1.numpy()
    ties = 0
    for b, pair in enumerate(pairs):
        assert sorted(ti[b].tolist()) == list(pair), b
        if td[b, 0] == td[b, 1] and d64[b, 0] != d64[b, 1]:
            ties += 1
            want = list(pair if d64[b, 0] < d64[b, 1] else pair[::-1])
            assert ti[b].tolist() == want and i1[b, 0] == want[0], b
    assert ties >= 10
