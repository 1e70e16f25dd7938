"""The row-major path (kernels B4/B5, ops/fused_knn) on its live query columns, the
three-way bf16 split of f32 rows, the build's hash, and the same-dtype certificate's norm
gap (ROADMAP C2), on the CPU against the JAX package (its Pallas kernels in interpret mode).

  * ``exact_knn_fused(n_live=n)`` computes the first n columns (rounded up to 8) of phase
    1, selects and rescans the live rows alone, and returns n rows: the same ids as the
    full plain call's first n rows and as ``exact_knn_pallas`` on the padded batch, with
    r1 and the scan gate read from the padded batch;
  * the engine on the default config and on ``dtype="bfloat16"`` against the JAX engine;
  * the split hi + mid + lo == x exactly; the six-product sum (what the kernel computes
    for f32 rows, evaluated here in plain torch) within Dp * 2^-23 * |q||x| of float64;
    the per-element budget ``fused_knn._phase1_budget`` covering both that evaluation and
    the plain version against the float64 window mins;
  * a changed header (``csrc/*.cuh``) changes the kernel library's name;
  * a bf16 store before any compaction, near-ties whose f32 and bf16 norms differ: JAX's
    same-dtype certificate proves a wrong set at tier 0, the port's (with the gap term)
    returns the exact set over the stored rows.
"""

import functools
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
from mlvectordb_tpu.ops import pallas_knn as J
from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.ops import _kernels
from mlvectordb_tpu_torch.ops import fused_knn as F
from mlvectordb_tpu_torch.ops import fused_knn_t as T
from mlvectordb_tpu_torch.ops.distances import MASKED
from mlvectordb_tpu_torch.ops.topk import exact_knn

D = 128
N = 2 * F.DB_TILE
K = 10
METRICS = ["l2", "ip", "cosine"]
ROWS = {"f32": torch.float32, "bf16": torch.bfloat16}
# (bucket, live counts in it): the engine pads 1 and 5 to 8, 16 to 64, 70 and 128 to 512
BUCKETS = {8: (1, 5), 64: (16,), 512: (70, 128)}
# the kernel's six products of the split (row part, query part): all but mid.lo, lo.mid
# and lo.lo
SIX = ((0, 2), (1, 1), (0, 1), (2, 0), (1, 0), (0, 0))


def _rows(x, rows):
    return torch.from_numpy(x).to(ROWS[rows])


@functools.lru_cache(maxsize=None)
def _corpus(rows, variant, bucket):
    """(db f32, valid, sq_norms, q [bucket, D]): gaussian rows, ~2% tombstones and a dead
    half tile for the masked variant."""
    rng = np.random.default_rng(1000 * bucket + 10 * len(rows) + len(variant))
    db = rng.standard_normal((N, D), dtype=np.float32)
    q = rng.standard_normal((bucket, D), dtype=np.float32)
    valid = np.ones(N, bool)
    if variant == "masked":
        valid = rng.random(N) > 0.02
        valid[-F.DB_TILE // 2:] = False
    return db, valid, (db * db).sum(-1).astype(np.float32), q


@functools.lru_cache(maxsize=None)
def _jax_result(rows, variant, metric, bucket):
    """exact_knn_pallas on the whole padded batch (interpret mode)."""
    db, valid, sq, q = _corpus(rows, variant, bucket)
    data = jnp.asarray(db) if rows == "f32" else jnp.asarray(db).astype(jnp.bfloat16)
    d, i = J.exact_knn_pallas(jnp.asarray(q), data, jnp.asarray(valid), jnp.asarray(sq), k=K,
                              metric=metric, live_prefix=N if variant == "fast" else None)
    return np.asarray(d), np.asarray(i)


def _torch_args(rows, variant, bucket, n_live):
    db, valid, sq, q = _corpus(rows, variant, bucket)
    qz = q.copy()
    qz[n_live:] = 0.0                                # the engine's zero padding
    return ((torch.from_numpy(qz), _rows(db, rows), torch.from_numpy(valid),
             torch.from_numpy(sq)), dict(k=K, live_prefix=N if variant == "fast" else None))


def _same_sets(ti, td, want_i, want_d):
    for b in range(ti.shape[0]):
        assert set(ti[b].tolist()) == set(np.asarray(want_i)[b].tolist()), b
    np.testing.assert_allclose(np.sort(td, 1), np.sort(np.asarray(want_d), 1), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("bucket,n_live", [(b, n) for b, ns in BUCKETS.items() for n in ns])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("variant", ["fast", "masked"])
@pytest.mark.parametrize("rows", list(ROWS))
def test_exact_knn_fused_live_rows_match_full_call_and_pallas(rows, variant, metric, bucket,
                                                              n_live):
    args, kw = _torch_args(rows, variant, bucket, n_live)
    seen = []
    name = "_window_mins_fast" if variant == "fast" else "_window_mins_masked"
    real = getattr(F, name)

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append((k["r1"], k.get("n_live"), out.shape[1]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, name, spy)
        td, ti = F.exact_knn_fused(*args, metric=metric, n_live=n_live, **kw)
        fd, fi = F.exact_knn_fused(*args, metric=metric, **kw)
    n_c = -(-n_live // 8) * 8
    r1 = F._pick_r1(bucket, N, K)                    # the padded batch's, as JAX's
    assert seen == [(r1, n_live, n_c), (r1, None, bucket)]
    assert td.shape == ti.shape == (n_live, K) and fd.shape == (bucket, K)
    _same_sets(ti.numpy(), td.numpy(), fi[:n_live].numpy(), fd[:n_live].numpy())
    jd, ji = _jax_result(rows, variant, metric, bucket)
    _same_sets(ti.numpy(), td.numpy(), ji[:n_live], jd[:n_live])


def test_r1_and_scan_gate_read_the_padded_batch():
    """r1 comes from the padded batch (16 live in the 64 bucket: r1 = 8, where 16 alone
    would pin 32); the scan gate too: a padded batch of 384 (not a multiple of the
    256-query tile) takes the scan though its 128 live queries alone would not; and a
    wide padded dimension (1408) takes the kernel's wrapper over f32 and bf16 rows alike,
    with the scan's answer."""
    assert F._pick_r1(64, N, K) == 8 and F._pick_r1(16, N, K) == 32
    args, kw = _torch_args("f32", "fast", 64, 16)
    seen = []
    real = F._window_mins_fast
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, "_window_mins_fast", lambda *a, **k: seen.append(k["r1"]) or real(*a, **k))
        F.exact_knn_fused(*args, metric="l2", n_live=16, **kw)
        assert seen == [8]
        rng = np.random.default_rng(5)
        db = rng.standard_normal((N, D), dtype=np.float32)
        q = np.zeros((384, D), np.float32)
        q[:128] = rng.standard_normal((128, D), dtype=np.float32)
        t = (torch.from_numpy(q), torch.from_numpy(db), torch.ones(N, dtype=torch.bool),
             torch.from_numpy((db * db).sum(-1)))
        d, i = F.exact_knn_fused(*t, k=K, metric="l2", live_prefix=N, n_live=128)
        assert seen == [8] and d.shape == (128, K)   # no kernel: the scan
        wd, wi = exact_knn(t[0][:128], *t[1:], k=K, metric="l2", db_tile=F.DB_TILE)
        assert torch.equal(i, wi) and torch.equal(d, wd)
        jd, ji = J.exact_knn_pallas(*(jnp.asarray(np.asarray(a)) for a in t), k=K,
                                    metric="l2", live_prefix=N)
        _same_sets(i.numpy(), d.numpy(), np.asarray(ji)[:128], np.asarray(jd)[:128])
    wide = 1408
    xw = torch.from_numpy(np.random.default_rng(6).standard_normal((N, wide), dtype=np.float32))
    qw = xw[:8] + 0.01
    for dtype in (torch.float32, torch.bfloat16):
        data = xw.to(dtype)
        t = (qw, data, torch.ones(N, dtype=torch.bool), (data.float() ** 2).sum(-1))
        launched = []
        real = F._window_mins_fast
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(F, "_window_mins_fast", lambda *a, **k: launched.append(1) or real(*a, **k))
            d, i = F.exact_knn_fused(*t, k=3, metric="l2", live_prefix=N)
        assert launched == [1]
        assert i[:, 0].tolist() == list(range(8))
        wd, wi = exact_knn(*t, k=3, metric="l2", db_tile=F.DB_TILE)
        assert torch.equal(i, wi)
        if dtype == torch.float32:   # (the scan multiplies bf16 rows by the bf16 query)
            # |q|^2 + |x|^2 ~ 2.8e3: the l2 expansion's f32 rounding is ~1e-3 absolute
            torch.testing.assert_close(d, wd, rtol=1e-4, atol=1e-2)


# ------------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def engines():
    """The same 12,000-row namespace in the JAX engine and in the port's, row-major, with
    f32 rows (the default config) and bf16 rows.  The JAX engine picks its fused backend
    only on a TPU; here it is told it runs on one, and its Pallas kernels run in
    interpret mode."""
    rng = np.random.default_rng(2027)
    x = rng.standard_normal((12_000, D), dtype=np.float32)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, len(x))]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backend, "jax", types.SimpleNamespace(default_backend=lambda: "tpu"))
        for dtype in ("float32", "bfloat16"):
            jqp = JaxQueryProcessor(config=JaxConfig(dtype=dtype))
            tqp = QueryProcessor(EngineConfig(dtype=dtype), device="cpu")
            jqp.bulk_load(x, "ns", ids=ids)
            tqp.bulk_load(x, "ns", ids=ids)
            gone = [ids[i] for i in rng.choice(len(ids), 50, replace=False)]
            out[dtype] = (jqp, tqp, gone)
        yield out


@pytest.mark.parametrize("b", [5, 16, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_row_major_with_live_count_matches_jax(engines, dtype, b):
    """Both variants (before and after deletes): the same ids and scores as the JAX
    engine, the kernel wrapper handed the live count and returning its columns."""
    jqp, tqp, gone = engines[dtype]
    queries = np.random.default_rng(b).standard_normal((b, D), dtype=np.float32)
    seen = []
    wrappers = {n: getattr(F, n) for n in ("_window_mins_fast", "_window_mins_masked")}

    def spying(real):
        def spy(*a, **k):
            out = real(*a, **k)
            seen.append((k.get("n_live"), out.shape[1]))
            return out
        return spy

    with pytest.MonkeyPatch.context() as mp:
        for n, real in wrappers.items():
            mp.setattr(F, n, spying(real))
        for step in ("before", "after"):
            if step == "after":
                if tqp.storage.namespace("ns").device_state().live_count == 12_000:
                    jqp.delete(gone, "ns")
                    tqp.delete(gone, "ns")
                queries = queries + np.float32(1e-3)   # past the result cache
            for metric in METRICS:
                jr = jqp.find_similar_batch([JaxDTO(v) for v in queries], K, "ns", metric)
                tr = tqp.find_similar_batch([VectorDTO(v) for v in queries], K, "ns", metric)
                for a, c in zip(jr, tr):
                    assert len(c) == K and {r["id"] for r in a} == {r["id"] for r in c}
                    np.testing.assert_allclose(sorted(r["score"] for r in c),
                                               sorted(r["score"] for r in a), rtol=1e-4,
                                               atol=1e-4)
    assert seen == [(b, -(-b // 8) * 8)] * 6


# ------------------------------------------------------------------ the three-way split


def test_split3_is_exact():
    rng = np.random.default_rng(9)
    n = 200_000                     # every binade from 2^-110 to 2^126, full significands
    x = np.concatenate([
        rng.choice([-1.0, 1.0], n) * rng.uniform(1.0, 2.0, n) * np.exp2(rng.integers(-110, 127, n)),
        rng.standard_normal(n),
        [0.0, -0.0, 1.0, -1.0, 2.0 ** -110, 3.3895313892515355e38, -3.3895313892515355e38,
         1 + 2.0 ** -8, 1 + 2.0 ** -8 - 2.0 ** -23, 1 - 2.0 ** -24, 2.0 ** 127 * (2 - 2.0 ** -7),
         np.float32(np.pi), np.float32(1 / 3)]]).astype(np.float32)
    xt = torch.from_numpy(x)
    hi, mid, lo = F._split3(xt)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, xt.double())
    # each part holds the next 8 significant bits: |mid| <= 2^-8 |x|, |lo| <= 2^-16 |x|
    assert bool((mid.double().abs() <= 2.0 ** -8 * xt.double().abs()).all())
    assert bool((lo.double().abs() <= 2.0 ** -16 * xt.double().abs()).all())


@pytest.mark.parametrize("n_c", [1, 5, 8, 16, 17, 127, 128])
def test_f32_query_operand_is_the_split(n_c):
    """Kernel B4's query operand for f32 rows: the first n_c queries as ``_split3``'s three
    bf16 parts [3, Bq, Dp], Bq = n_c rounded up to 8, zero past n_c, hi + mid + lo == q
    element by element; the one-part operand (bf16 rows) is the queries rounded to bf16."""
    rng = np.random.default_rng(n_c)
    q = torch.from_numpy(rng.standard_normal((132, 384), dtype=np.float32))
    q[0, :3] = torch.tensor([2.0 ** -100, -3.0e38, 0.0])
    q[:, 7] *= 2.0 ** 40
    got = F._query_parts(q, n_c, split=True)
    bq = -(-n_c // 8) * 8
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, bq, 384)
    for part, want in zip(got, F._split3(q[:n_c])):
        assert torch.equal(part[:n_c].view(torch.int16), want.view(torch.int16))
        assert not bool(part[n_c:].any())
    assert torch.equal(got.double().sum(0)[:n_c], q[:n_c].double())
    one = F._query_parts(q, n_c, split=False)
    assert tuple(one.shape) == (1, bq, 384)
    assert torch.equal(one[0, :n_c], q[:n_c].to(torch.bfloat16)) and not bool(one[0, n_c:].any())


def _hard(rng, n, d, lo_exp, hi_exp):
    """f32 values with full significands over exponents lo_exp .. hi_exp, random signs,
    every other row's second half the negated first half (cancelling sums)."""
    x = (rng.choice([-1.0, 1.0], (n, d)) * rng.uniform(1.0, 2.0, (n, d))
         * np.exp2(rng.integers(lo_exp, hi_exp + 1, (n, d))))
    x[::2, d // 2:] = -x[::2, : d // 2]
    return torch.from_numpy(x.astype(np.float32))


def _six_product_dots(x, q):
    """[N, B] dots of f32 rows x and f32 queries q as the kernel forms them for f32 rows:
    the six products of the two splits, each exact, summed in f32."""
    xs, qs = F._split3(x), F._split3(q)
    out = torch.zeros((x.shape[0], q.shape[0]))
    for i, j in SIX:
        out = out + xs[i].float() @ qs[j].float().T
    return out


@pytest.mark.parametrize("kind", ["gaussian", "hard"])
def test_split_six_products_within_the_bar(kind):
    """The six-product sum against float64: max |dot - exact| / (|q||x|) within the bar
    Dp * 2^-23 the card holds the kernel to (the dropped mid.lo + lo.mid + lo.lo terms
    are at most 2^-23 of it, the f32 sums the rest)."""
    rng = np.random.default_rng(13)
    if kind == "gaussian":
        x = torch.from_numpy(rng.standard_normal((4096, D), dtype=np.float32))
        q = torch.from_numpy(rng.standard_normal((64, D), dtype=np.float32))
    else:
        x, q = _hard(rng, 4096, D, -20, 10), _hard(rng, 64, D, -4, 4)
    exact = x.double() @ q.double().T
    norms = (torch.linalg.vector_norm(x.double(), dim=1)[:, None]
             * torch.linalg.vector_norm(q.double(), dim=1)[None, :])
    rel = (_six_product_dots(x, q).double() - exact).abs() / norms
    assert float(rel.max()) <= D * 2.0 ** -23, float(rel.max())
    # the split keeps f32 accuracy where one bf16 pass of the same values would not
    one = (x.to(torch.bfloat16).float() @ q.to(torch.bfloat16).float().T).double()
    assert float(((one - exact).abs() / norms).max()) > D * 2.0 ** -23


def _formula(dots, sqn, qn, metric, hw=None, bias=None):
    """The kernels' distance formula (pallas_knn.py:115-125, 143-151) on [N, B] dots."""
    if bias is None:
        if metric == "l2":
            d = torch.clamp_min(sqn + qn - 2.0 * dots, 0.0)
        elif metric == "ip":
            d = 1.0 - dots
        else:
            d = 1.0 - dots * torch.rsqrt(torch.clamp_min(sqn * qn, 1e-30))
        row = torch.arange(dots.shape[0])[:, None]
        return torch.where(row < hw, d, torch.full_like(d, float(MASKED)))
    if metric == "l2":
        return torch.clamp_min(bias + qn - 2.0 * dots, 0.0)
    if metric == "ip":
        return 1.0 - dots + bias
    return 1.0 - dots * torch.rsqrt(torch.clamp_min(sqn * qn, 1e-30)) + bias


def _wmin(dist, r1):
    W = F.DB_TILE // r1
    return dist.reshape(-1, r1, W, dist.shape[1]).amin(1).reshape(-1, dist.shape[1])


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("variant", ["fast", "masked"])
@pytest.mark.parametrize("rows", list(ROWS))
def test_phase1_budget_covers_split_and_plain_against_float64(rows, variant, metric):
    """The per-element budget B4/B5 are held to on the card bounds |kernel - plain|: here
    both the kernel's arithmetic (evaluated in plain torch: the split's six products for
    f32 rows, one bf16 pass for bf16 rows, f32 norms) and the plain version stay within it
    of the float64 window mins, on gaussian and hard rows."""
    rng = np.random.default_rng(17 + len(metric) + len(variant))
    x32 = torch.cat([torch.from_numpy(rng.standard_normal((F.DB_TILE, D), dtype=np.float32)),
                     _hard(rng, F.DB_TILE, D, -12, 6)])
    data = x32.to(ROWS[rows])
    q = _hard(rng, 16, D, -4, 4)
    qt = q.T.to(ROWS[rows]).float().contiguous()
    qn = (q * q).sum(-1)[None, :]
    r1 = 8
    kw = dict(metric=metric, db_tile=F.DB_TILE, r1=r1)
    hw, bias = N - F.DB_TILE, None                   # a dead last tile: masked windows
    if variant == "masked":
        valid = torch.from_numpy(rng.random(N) > 0.02)
        valid[-F.DB_TILE:] = False
        maskadd = torch.where(valid, 0.0, float(MASKED))
        bias = ((x32 * x32).sum(-1) + maskadd if metric == "l2" else maskadd)[:, None]
    xf = data.float()
    sqn = (xf * xf).sum(1, keepdim=True)
    if rows == "f32":
        dots = _six_product_dots(xf, qt.T)
    else:
        dots = xf @ qt
    kernel = _wmin(_formula(dots, sqn, qn, metric, hw, bias), r1)
    x64 = data.double()
    exact = _wmin(_formula(x64 @ qt.double(), (x64 * x64).sum(1, keepdim=True), qn.double(),
                           metric, hw, None if bias is None else bias.double()), r1)
    if variant == "fast":
        plain = F._window_mins_fast_ref(data, qt, qn, hw, **kw)
        budget = F._phase1_budget(data, qt, qn, hw=hw, **kw)
    else:
        plain = F._window_mins_masked_ref(data, qt, qn, bias, **kw)
        budget = F._phase1_budget(data, qt, qn, bias=bias, **kw)
    assert budget.shape == plain.shape == kernel.shape
    live = exact < MASKED / 2
    assert bool(live.any()) and bool((~live).any())
    for got in (kernel, plain):
        assert torch.equal(got[~live], torch.full_like(got[~live], float(MASKED)))
        err = torch.where(live, (got.double() - exact).abs(), torch.zeros_like(exact))
        assert bool((err <= budget.double()).all()), float((err / budget).max())


# ------------------------------------------------------------------ the build


def test_library_name_follows_headers(tmp_path, monkeypatch):
    """The library's name hashes every source and every shared header, so an edited
    header never loads a library built from the old one; only sources are compiled."""
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_kernels, "_CSRC", tmp_path)
    first = _kernels.library_path()
    assert _kernels.library_path() == first
    assert [p.name for p in _kernels._sources()] == ["a.cu"]
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = _kernels.library_path()
    assert second != first and second.parent == first.parent
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _kernels.library_path() not in (first, second)


# ------------------------------------------------------------------ ROADMAP C2


def test_same_dtype_certificate_covers_the_norm_gap():
    """A bf16 store with the same-dtype sweep, before any compaction.  Row A rounds to the
    query itself (distance 0 over the stored rows) but its written f32 norm is larger by
    0.94; sixteen decoys sit at 0.25-0.38 and 24 more at 0.71.  The JAX store's bias row
    holds the written norms and its plan carries only the query's rounding: it ranks A's
    window behind the decoys and proves the decoys at tier 0, a wrong set.  The port's
    store holds the stored rows' norms (ROADMAP C17), so its norm-gap row is zero and the
    exact set comes back at tier 0.  Handed the written norms, as the JAX store holds
    them, the port's plan carries the gap (ROADMAP C2): A's window still ranks first."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((N, D)) + 8).astype(np.float32)          # far rows
    q = np.ones(D, np.float32)                                         # bf16-exact
    a_row = 100
    x[a_row] = np.float32(1 + 2.0 ** -8 - 2.0 ** -12)                  # rounds to 1.0
    for i, r in enumerate(range(1000, 1000 + 40 * 64, 64)):            # one per window
        x[r] = 1.0
        x[r, i % D] += np.float32(0.5 + i / 128 if i < 16 else 0.84375)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, N)]
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    dist = ((xb - q.astype(np.float64)) ** 2).sum(1)
    want = set(np.argsort(dist)[:K].tolist())
    assert a_row in want and np.sort(dist)[K] > np.sort(dist)[K - 1]   # no tie at k
    cfg = dict(dtype="bfloat16", sweep_dtype="bfloat16")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backend, "jax", types.SimpleNamespace(default_backend=lambda: "tpu"))
        jqp = JaxQueryProcessor(config=JaxConfig(**cfg))
        jqp.bulk_load(x, "ns", ids=ids)
        jr = jqp.find_similar_batch([JaxDTO(q)], K, "ns", "l2")[0]
    tqp = QueryProcessor(EngineConfig(**cfg), device="cpu")
    tqp.bulk_load(x, "ns", ids=ids)
    tr = tqp.find_similar_batch([VectorDTO(q)], K, "ns", "l2")[0]
    index = {v: i for i, v in enumerate(ids)}
    jax_set, port_set = {index[r["id"]] for r in jr}, {index[r["id"]] for r in tr}
    # the reference: tier 0, A missing (its scores are the decoys')
    assert jqp.cert_tier_counts("ns") == {"fast": 1}
    assert a_row not in jax_set and jax_set != want
    # the port: the exact set over the stored rows, A first at distance 0
    assert port_set == want and tr[0]["id"] == ids[a_row] and tr[0]["score"] == 0.0
    assert tqp.cert_tier_counts("ns") == {"fast": 1}
    st = tqp.storage.namespace("ns").device_state()
    gaps = [p["eb_rows"][1] for p in st.prep_cache.values()]
    assert len(gaps) == 1 and float(gaps[0].abs().max()) == 0.0
    # the written rows' norms, as the JAX store holds them: a gap of 0.94 on A's row
    written = np.zeros((st.capacity, st.data.shape[1]), np.float32)
    written[:N, :D] = x
    sqn = torch.from_numpy((written * written).sum(-1))
    cache = {}
    q_t = torch.zeros((8, st.data.shape[1]))
    q_t[0, :D] = torch.from_numpy(q)
    d, i, tier = T.exact_knn_t(q_t, st.data, st.data, st.valid, sqn, k=K, metric="l2",
                               live_prefix=st.high_water, prep_cache=cache,
                               report_tier=True)
    gap = [p["eb_rows"][1] for p in cache.values() if isinstance(p, dict) and "eb_rows" in p]
    assert float(gap[0][a_row]) > 0.9 and float(gap[0][1000]) == 0.0
    assert tier == 0 and set(i[0].tolist()) == want and int(i[0, 0]) == a_row
