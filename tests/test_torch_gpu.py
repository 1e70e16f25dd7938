"""The CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: each test skips without CUDA (decided inside the fixture, never at
import).  Run on a machine with an H100, without the JAX test harness of
tests/conftest.py:  python -m pytest --noconftest tests/test_torch_gpu.py -q
Row-major window-min kernels (csrc/window_min.cu, on the tensor cores: bf16 rows one pass,
f32 rows a three-way bf16 split): live windows within the per-element budget
``fused_knn._phase1_budget`` of the plain f32 version (Dp * 2^-23 of |q||x| per dot for the
tensor cores, Dp * 2^-24 for the plain sums, the norms and the epilogue's roundings); a
launch of the live columns alone bit-equal to the same columns of the full launch; the
dots against float64 within Dp * 2^-23 of |q||x|.  The sweep
kernel (csrc/sweep_min.cu): live window mins within the per-element phase-1 budget
(``fused_knn_t._phase1_budget``: Dp * 2^-23 of |a||b| per pass for the tensor cores'
sums, Dp * 2^-24 for the plain version's, the largest over the window's rows), which sits
inside the certificate's slack Dp * 2^-22 * |qh| * maxd; its pool and block mins
bit-equal to the plain pool and min of the kernel's own window mins; a launch of the live
columns alone bit-equal to the full launch.  The rescan (csrc/gather_score.cu): dots and
norms within Dp * 2^-24 of |q| |row| + |row|^2 at Dp = 128, 384 and 1536; a launch of the
live rows (and the first padded one) bit-equal to the full launch; the engine's results
the same with the rescan on the live rows as on every row.  Fully masked windows are exactly 3e38
everywhere.
"""

import uuid

import numpy as np
import pytest
import torch

from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.ops import fused_knn, fused_knn_t
from mlvectordb_tpu_torch.ops.distances import MASKED

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, budget):
    """Live windows within the per-element budget, fully masked windows exactly 3e38."""
    dead = want == MASKED
    assert torch.equal(got[dead], want[dead])
    err = torch.where(dead, torch.zeros_like(got), (got - want).abs())
    assert bool((err <= budget).all()), float((err / budget).max())


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("r1", [8, 32])
@pytest.mark.parametrize("b", [8, 132, 512])
def test_kernels_match_plain(cuda, metric, r1, b):
    rng = np.random.default_rng(r1 * 1000 + b)
    n = 65536
    data = torch.from_numpy(rng.standard_normal((n, 128), dtype=np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, 128), dtype=np.float32)).to(cuda)
    qt, qn = q.T.contiguous(), (q * q).sum(-1)[None, :].contiguous()
    kw = dict(metric=metric, db_tile=fused_knn.DB_TILE, r1=r1)
    hw = n - fused_knn.DB_TILE - 1234
    before = fused_knn._window_mins_fast.launches
    got = fused_knn._window_mins_fast(data, qt, qn, hw, **kw)
    torch.cuda.synchronize()
    assert fused_knn._window_mins_fast.launches == before + 1
    _close(got, fused_knn._window_mins_fast_ref(data, qt, qn, hw, **kw),
           fused_knn._phase1_budget(data, qt, qn, hw=hw, **kw))

    valid = torch.from_numpy(rng.random(n) > 0.01).to(cuda)
    valid[-fused_knn.DB_TILE:] = False
    maskadd = torch.where(valid, 0.0, float(MASKED))
    bias = ((data * data).sum(-1) + maskadd if metric == "l2" else maskadd)[:, None].contiguous()
    got = fused_knn._window_mins_masked(data, qt, qn, bias, **kw)
    torch.cuda.synchronize()
    _close(got, fused_knn._window_mins_masked_ref(data, qt, qn, bias, **kw),
           fused_knn._phase1_budget(data, qt, qn, bias=bias, **kw))


def test_kernel_rejects_bad_operands(cuda):
    data = torch.zeros((8192, 128), device=cuda)
    with pytest.raises(ValueError):
        fused_knn._window_mins_fast(data, torch.zeros((128, 6), device=cuda),
                                    torch.zeros((1, 6), device=cuda), 10,
                                    metric="l2", db_tile=4096, r1=8)


@pytest.mark.parametrize("b", [16, 128])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_engine_on_cuda_matches_cpu(cuda, metric, b):
    """The default config's row-major path: B = 16 (64 bucket) and B = 128 (512 bucket),
    each computing its live columns alone; the same ids on the card as on the CPU."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((20000, 128), dtype=np.float32)
    q = [VectorDTO(v) for v in rng.standard_normal((b, 128), dtype=np.float32)]
    fn = fused_knn._window_mins_fast
    out = []
    for device in ("cpu", cuda):
        qp = QueryProcessor(EngineConfig(), device=device)
        ids = qp.bulk_load(x, "ns", ids=None if not out else out[0][0])
        before = (fn.launches, fn.cols)
        res = qp.find_similar_batch(q, 10, "ns", metric)
        launched = (fn.launches - before[0], fn.cols - before[1])
        qp.delete(ids[::50], "ns")
        res2 = qp.find_similar_batch(q, 10, "ns", metric)
        out.append((ids, res, res2, launched))
    (_, c1, c2, _), (_, g1, g2, launched) = out
    assert launched == (1, b)
    for a, b in ((c1, g1), (c2, g2)):
        for ra, rb in zip(a, b):
            assert [r["id"] for r in ra] == [r["id"] for r in rb]
            np.testing.assert_allclose([r["score"] for r in ra], [r["score"] for r in rb],
                                       rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ certified sweep (B1, B2)


# the sweep kernel's programs: the bf16 mirror's light and heavy ones, an int8 mirror's
# one pass, two_pass, and two_pass with the second stream, the f32 mirror's; each with the
# per-row bound rows the certificate plan folds into it
PROGRAMS = {"light": ("err1", "sqn_sqrt"), "heavy": ("sweep_err", "err1"),
            "int8_light": ("err1", "sqn_sqrt"), "int8_two_pass": ("sweep_err",),
            "int8_resid": ("sweep_err", "err1"), "f32": ()}


def _sweep_operands(dev, n, b, metric, program, seed, n_live=None):
    """Kernels B1/B3's operands as the certified search builds them for ``program`` (a
    key of PROGRAMS), with ~1% tombstones and a dead last tile in the bias row; queries
    from ``n_live`` on are the engine's zero padding."""
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.standard_normal((n, 128), dtype=np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, 128), dtype=np.float32)).to(dev)
    if n_live is not None:
        q[n_live:] = 0.0
    valid = torch.from_numpy(rng.random(n) > 0.01).to(dev)
    valid[-fused_knn_t.SWEEP_TILE:] = False
    wb = PROGRAMS[program]
    mirror_dtype = (torch.float32 if program == "f32" else torch.int8
                    if program.startswith("int8") else torch.bfloat16)
    resid = program in ("heavy", "int8_resid")
    if mirror_dtype == torch.bfloat16:
        z, s, e2, e1 = fused_knn_t.quantize_resid_rows(data)
        mirror, s2 = data.to(torch.bfloat16), None
    else:
        mirror, s, z, s2, e2, e1 = fused_knn_t.quantize_int8_resid_rows(data)
        mirror = data if program == "f32" else mirror
    prep = fused_knn_t._prep_terms(
        valid, (data * data).sum(-1), n, s, e2, e1, cap=n, metric=metric, masked=True,
        use_resid=resid, wb_sources=wb, rscale2=s2, int8_sweep=mirror_dtype == torch.int8)
    qh, qres, qres_f32 = fused_knn_t._fold_query(q, metric, program.endswith("light"),
                                                 mirror_dtype)
    qn = torch.linalg.vector_norm(q, dim=1) * (2.0 if metric == "l2" else 1.0)
    qe = torch.stack([qn, torch.linalg.vector_norm(qres_f32, dim=1)], 1)[:, :len(wb)]
    args = (qh.contiguous(), qres, mirror, z if resid else None, prep["rscale_row"],
            prep["scale_row"], prep["bias_row"])
    slack = 128 * 2.0 ** -22 * qn * (1.0 if metric == "cosine" else prep["maxd"])
    return args, dict(qe=qe.contiguous() if wb else None, eb_rows=prep["eb_rows"]), slack


def _close_slack(got, want, slack):
    dead = want == MASKED
    assert torch.equal(got[dead], want[dead])
    err = torch.where(dead, torch.zeros_like(got), (got - want).abs())
    assert bool((err <= slack).all()), float((err / slack).max())


def _budget(args, kw, r1, transposed=True):
    return fused_knn_t._phase1_budget(*args, r1=r1, qe=kw["qe"], eb_rows=kw["eb_rows"],
                                      transposed=transposed)


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("r1", [32, 16, 4, 1])
@pytest.mark.parametrize("b", [8, 132])
def test_sweep_kernel_matches_plain(cuda, heavy, metric, r1, b):
    args, kw, slack = _sweep_operands(cuda, 16384, b, metric, "heavy" if heavy else "light",
                                       r1 * 100 + b)
    kw["emit_block_mins"] = r1 == 32
    before = (fused_knn_t._window_mins_t.launches, fused_knn_t._window_mins_t.launches_heavy)
    got, bm, pool = fused_knn_t._window_mins_t(*args, r1=r1, **kw)
    torch.cuda.synchronize()
    assert (fused_knn_t._window_mins_t.launches,
            fused_knn_t._window_mins_t.launches_heavy) == (before[0] + 1, before[1] + heavy)
    want, want_bm, _ = fused_knn_t._window_mins_t_ref(*args, r1=r1, **kw)
    assert pool is None
    budget = _budget(args, kw, r1)
    _close_slack(got, want, budget)
    assert bool((budget <= slack[None, :, None]).all())
    assert bool((want == MASKED).any())
    if r1 == 32:
        _close_slack(bm, want_bm, budget.amax(-1))
        assert torch.equal(_bits(bm), _bits(got.amin(-1)))


def _gather_operands(dev, rows, r1, d, seed, b=132, s1=37, cap=65536):
    """Kernel B2's operands: ``cap`` x ``d`` rows of type ``rows``, b queries, s1 sorted
    window ids a query with repeats and out-of-range ids (the kernel clamps them); b and
    s1 divide no stage or CTA shape of the kernel."""
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.standard_normal((cap, d), dtype=np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(dev)
    f = torch.randint(-2, cap // r1 + 2, (b, s1), device=dev)
    f[:, 1] = f[:, 0]
    return q, data.to(rows), torch.sort(f, 1).values.to(torch.int32).contiguous()


def _check_gather(q, data, f, r1, got):
    """B2's dots and norms within D * 2^-24 of |q| |row| + |row|^2 of the plain version's
    (the same f32 sums in another order)."""
    dots, sqn = got
    want_dots, want_sqn = fused_knn_t._gather_score_ref(q, data, f, r1=r1)
    bound = q.shape[1] * 2.0 ** -24 * (torch.linalg.vector_norm(q, dim=1)[:, None]
                                       * want_sqn.sqrt() + want_sqn)
    assert bool(((dots - want_dots).abs() <= bound).all())
    assert bool(((sqn - want_sqn).abs() <= bound).all())


@pytest.mark.parametrize("d", [128, 384, 1536])
@pytest.mark.parametrize("r1", [32, 16, 8, 4])
def test_gather_score_kernel_matches_plain(cuda, r1, d):
    q, data, f = _gather_operands(cuda, torch.float32, r1, d, r1 + d,
                                  cap=65536 if d == 128 else 16384)
    c = fused_knn_t._gather_score
    before = (c.launches, c.rows)
    got = c(q, data, f, r1=r1)
    torch.cuda.synchronize()
    assert (c.launches, c.rows) == (before[0] + 1, before[1] + f.numel() * r1)
    _check_gather(q, data, f, r1, got)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_sweep_engine_on_cuda_matches_cpu(cuda, metric):
    rng = np.random.default_rng(17)
    x = rng.standard_normal((20000, 128), dtype=np.float32)
    q = [VectorDTO(v) for v in rng.standard_normal((16, 128), dtype=np.float32)]
    out = []
    for device in ("cpu", cuda):
        qp = QueryProcessor(EngineConfig(sweep_dtype="bfloat16"), device=device)
        ids = qp.bulk_load(x, "ns", ids=None if not out else out[0][0])
        before = (fused_knn_t._window_mins_t.launches, fused_knn_t._gather_score.launches)
        res = qp.find_similar_batch(q, 10, "ns", metric)
        launched = (fused_knn_t._window_mins_t.launches - before[0],
                    fused_knn_t._gather_score.launches - before[1])
        qp.delete(ids[::50], "ns")
        res2 = qp.find_similar_batch(q, 10, "ns", metric)
        out.append((ids, res, res2, launched, qp.cert_tier_counts("ns")))
    (_, c1, c2, _, ccpu), (_, g1, g2, launched, cgpu) = out
    assert launched == (1, 1) and ccpu == cgpu == {"light_fast": 2}
    for a, b in ((c1, g1), (c2, g2)):
        for ra, rb in zip(a, b):
            assert {r["id"] for r in ra} == {r["id"] for r in rb}
            np.testing.assert_allclose(sorted(r["score"] for r in ra),
                                       sorted(r["score"] for r in rb), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("light", [True, False])
def test_sweep_tiers_on_cuda_match_cpu(cuda, light):
    """The same certified search on the CPU (plain versions) and on the card (kernels):
    a benign batch with one query aimed at a tight far cluster, whose proof fails in
    both programs, so both serve it from the contained escalation (tier 1)."""
    rng = np.random.default_rng(5)
    n = 20 * fused_knn_t.SWEEP_TILE
    x = rng.standard_normal((n, 128), dtype=np.float32)
    q = rng.standard_normal((16, 128), dtype=np.float32)
    centre = np.full(128, 4.0, np.float32)
    x[1000:1800] = centre + rng.standard_normal((800, 128)).astype(np.float32) * 1e-3
    q[0] = centre + rng.standard_normal(128).astype(np.float32) * 1e-3
    out = []
    for device in ("cpu", cuda):
        data = torch.from_numpy(x).to(device)
        z, s, e2, e1 = fused_knn_t.quantize_resid_rows(data)
        d, i, tier = fused_knn_t.exact_knn_t(
            torch.from_numpy(q).to(device), data.to(torch.bfloat16), data,
            torch.ones(n, dtype=torch.bool, device=device), (data * data).sum(-1), k=10,
            metric="l2", live_prefix=n, sweep_err=e2, resid=z, rscale=s, err1=e1,
            light=light, report_tier=True)
        out.append((d.cpu().numpy(), i.cpu().numpy(), tier))
    (dc, ic, tc), (dg, ig, tg) = out
    assert tc == tg == 1
    np.testing.assert_allclose(np.sort(dg, 1), np.sort(dc, 1), rtol=1e-4, atol=1e-4)
    for b in range(1, 16):                       # gaussian queries: no ties
        assert set(ig[b].tolist()) == set(ic[b].tolist())


# ------------------------------------------------------------------ the top-m pool (B1, B3)


@pytest.mark.parametrize("skip_wm", [False, True])
@pytest.mark.parametrize("r1,m", [(16, 8), (16, 16), (8, 8), (32, 10)])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("heavy", [False, True])
def test_pool_kernel_matches_plain(cuda, heavy, metric, r1, m, skip_wm):
    """The pool is the kernel's own window mins ordered by (value, position): bit-equal to
    the plain pool of those mins, padding and positions included; the mins within the
    phase-1 budget of the plain version's."""
    b = 512 if skip_wm else 8
    args, kw, slack = _sweep_operands(cuda, 65536, b, metric, "heavy" if heavy else "light",
                                       r1 * 10 + m + b)
    before = fused_knn_t._window_mins_t.launches_topm
    wmin, bm, pool = fused_knn_t._window_mins_t(*args, r1=r1, emit_topm=m, skip_wm=skip_wm,
                                                **kw)
    torch.cuda.synchronize()
    assert fused_knn_t._window_mins_t.launches_topm == before + 1
    assert bm is None and (wmin is None) == skip_wm
    assert tuple(pool.shape) == (16, fused_knn_t._topm_sub_rows(m), b)
    own = wmin if wmin is not None else fused_knn_t._window_mins_t(*args, r1=r1, **kw)[0]
    # bit patterns: NaN and +inf entries compare too
    assert torch.equal(pool.view(torch.int32),
                       fused_knn_t._topm_pool_ref(own, m).view(torch.int32))
    want_wmin = fused_knn_t._window_mins_t_ref(*args, r1=r1, **kw)[0]
    _close_slack(own, want_wmin, _budget(args, kw, r1))


def test_pool_kernel_rejects_bad_operands(cuda):
    args, kw, _ = _sweep_operands(cuda, 16384, 8, "l2", "light", 3)
    for bad in (dict(r1=8, emit_topm=10),                       # m * g > 32
                dict(r1=16, emit_topm=9),                       # odd m
                dict(r1=32, emit_topm=8, emit_block_mins=True),  # the pool beside block mins
                dict(r1=16, skip_wm=True)):                     # skip_wm without the pool
        with pytest.raises(ValueError):
            fused_knn_t._window_mins_t(*args, **bad, **kw)


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("light", [True, False])
def test_nan_query_tier_on_cuda_matches_cpu(cuda, light, k):
    """A NaN query: the kernel's mins are NaN where the plain version's are (jnp.minimum's
    rule), its proof fails, and the batch is served by the exact scan on both devices."""
    rng = np.random.default_rng(11)
    n = 65536
    x = rng.standard_normal((n, 128), dtype=np.float32)
    q = rng.standard_normal((8, 128), dtype=np.float32)
    q[2, 5] = np.nan
    out = []
    for device in ("cpu", cuda):
        data = torch.from_numpy(x).to(device)
        z, s, e2, e1 = fused_knn_t.quantize_resid_rows(data)
        d, i, tier = fused_knn_t.exact_knn_t(
            torch.from_numpy(q).to(device), data.to(torch.bfloat16), data,
            torch.ones(n, dtype=torch.bool, device=device), (data * data).sum(-1), k=k,
            metric="l2", live_prefix=n, sweep_err=e2, resid=z, rscale=s, err1=e1,
            light=light, report_tier=True)
        out.append((i.cpu().numpy(), tier))
    (ic, tc), (ig, tg) = out
    assert tc == tg == 2
    for b in (0, 1, 3, 4, 5, 6, 7):
        assert set(ig[b].tolist()) == set(ic[b].tolist())
    args, kw, _ = _sweep_operands(cuda, n, 8, "l2", "light" if light else "heavy", 12)
    args = (args[0].clone(),) + args[1:]
    args[0][2, 5] = float("nan")
    r1, m = (32, 0) if k == 10 else (16, 8)
    opts = dict(r1=r1, emit_block_mins=r1 == 32, emit_topm=m)
    got = fused_knn_t._window_mins_t(*args, **opts, **kw)
    want = fused_knn_t._window_mins_t_ref(*args, **opts, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(torch.isnan(g), torch.isnan(w)) and bool(torch.isnan(w).any())


@pytest.mark.parametrize("b", [8, 64])
def test_k100_engine_on_cuda_matches_cpu(cuda, b):
    """k=100 at 2^18 rows (k bucket 128, m = 10): bucket 8 keeps the window mins beside the
    pool, bucket 64 writes the pool only; tiers and id sets as on the CPU."""
    rng = np.random.default_rng(19)
    x = rng.standard_normal((1 << 18, 128), dtype=np.float32)
    q = [VectorDTO(v) for v in rng.standard_normal((b, 128), dtype=np.float32)]
    out = []
    for device in ("cpu", cuda):
        qp = QueryProcessor(EngineConfig(sweep_dtype="bfloat16"), device=device)
        ids = qp.bulk_load(x, "ns", ids=None if not out else out[0][0])
        before = fused_knn_t._window_mins_t.launches_topm
        res = qp.find_similar_batch(q, 100, "ns", "l2")
        out.append((ids, res, qp.cert_tier_counts("ns"),
                    fused_knn_t._window_mins_t.launches_topm - before))
    (_, rc, tc, _), (_, rg, tg, launched) = out
    assert tc == tg == {"light_fast": 1} and launched == 1
    for a, c in zip(rc, rg):
        assert len(c) == 100 and {r["id"] for r in a} == {r["id"] for r in c}
        np.testing.assert_allclose(sorted(r["score"] for r in a),
                                   sorted(r["score"] for r in c), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ NaN in B4 / B5


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("variant", ["fast", "masked"])
def test_window_min_nan_query_matches_plain(cuda, variant, metric):
    """A NaN query's window mins are NaN exactly where the plain version's are (the JAX
    kernels' jnp.maximum / jnp.minimum rule), live prefix and tombstoned alike."""
    rng = np.random.default_rng(23)
    n = 65536
    data = torch.from_numpy(rng.standard_normal((n, 128), dtype=np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((8, 128), dtype=np.float32)).to(cuda)
    q[3, 11] = float("nan")
    qt, qn = q.T.contiguous(), (q * q).sum(-1)[None, :].contiguous()
    kw = dict(metric=metric, db_tile=fused_knn.DB_TILE, r1=8)
    live = [b for b in range(8) if b != 3]
    if variant == "fast":
        hw = n - fused_knn.DB_TILE - 1234
        got = fused_knn._window_mins_fast(data, qt, qn, hw, **kw)
        want = fused_knn._window_mins_fast_ref(data, qt, qn, hw, **kw)
        budget = fused_knn._phase1_budget(data, qt[:, live], qn[:, live], hw=hw, **kw)
    else:
        valid = torch.from_numpy(rng.random(n) > 0.01).to(cuda)
        valid[-fused_knn.DB_TILE:] = False
        maskadd = torch.where(valid, 0.0, float(MASKED))
        bias = ((data * data).sum(-1) + maskadd if metric == "l2" else maskadd)
        bias = bias[:, None].contiguous()
        got = fused_knn._window_mins_masked(data, qt, qn, bias, **kw)
        want = fused_knn._window_mins_masked_ref(data, qt, qn, bias, **kw)
        budget = fused_knn._phase1_budget(data, qt[:, live], qn[:, live], bias=bias, **kw)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and bool(torch.isnan(want[:, 3]).any())
    _close(got[:, live], want[:, live], budget)


# ------------------------------------------------------------------ B3: int8 and f32 mirrors


@pytest.mark.parametrize("r1,outputs", [(32, "block_mins"), (16, "pool"), (16, "pool_only"),
                                        (4, "window_mins")])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("program", ["int8_light", "int8_two_pass", "int8_resid", "f32"])
def test_b3_kernel_matches_plain(cuda, program, metric, r1, outputs):
    """The window mins within the phase-1 budget of the plain version's (int8: exact
    products, tensor-core sums; f32: rounded products, f32 sums), the block mins and the
    pool bit-equal to the plain min and pool of the kernel's own mins."""
    b = 512 if outputs == "pool_only" else 8
    args, kw, slack = _sweep_operands(cuda, 65536, b, metric, program, r1 * 10 + b)
    opts = dict(emit_block_mins=outputs == "block_mins",
                emit_topm=8 if outputs.startswith("pool") else 0,
                skip_wm=outputs == "pool_only")
    counter = "launches_f32" if program == "f32" else "launches_int8"
    before = getattr(fused_knn_t._window_mins_t, counter)
    got = fused_knn_t._window_mins_t(*args, r1=r1, **opts, **kw)
    torch.cuda.synchronize()
    assert getattr(fused_knn_t._window_mins_t, counter) == before + 1
    want = fused_knn_t._window_mins_t_ref(*args, r1=r1, **opts, **kw)
    if opts["skip_wm"]:
        want = (None,) + want[1:]
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
    own = got[0] if got[0] is not None else fused_knn_t._window_mins_t(*args, r1=r1, **kw)[0]
    want_wmin = fused_knn_t._window_mins_t_ref(*args, r1=r1, **kw)[0]
    budget = _budget(args, kw, r1)
    assert bool((budget <= slack[None, :, None]).all())
    _close_slack(own, want_wmin, budget)
    if opts["emit_block_mins"]:
        _close_slack(got[1], want[1], budget.amax(-1))
        assert torch.equal(_bits(got[1]), _bits(own.amin(-1)))
    if opts["emit_topm"]:
        assert torch.equal(got[2].view(torch.int32),
                           fused_knn_t._topm_pool_ref(own, 8).view(torch.int32))


@pytest.mark.parametrize("kind", ["int8", "int8_no_resid", "float32"])
def test_int8_f32_engine_on_cuda_matches_cpu(cuda, kind):
    rng = np.random.default_rng(29)
    x = rng.standard_normal((20000, 128), dtype=np.float32)
    q = [VectorDTO(v) for v in rng.standard_normal((16, 128), dtype=np.float32)]
    cfg = EngineConfig(sweep_dtype=kind.split("_")[0], sweep_resid=kind != "int8_no_resid")
    counter = "launches_f32" if kind == "float32" else "launches_int8"
    out = []
    for device in ("cpu", cuda):
        qp = QueryProcessor(cfg, device=device)
        ids = qp.bulk_load(x, "ns", ids=None if not out else out[0][0])
        before = getattr(fused_knn_t._window_mins_t, counter)
        res = {m: qp.find_similar_batch(q, 10, "ns", m) for m in ("l2", "ip", "cosine")}
        launched = getattr(fused_knn_t._window_mins_t, counter) - before
        qp.delete(ids[::50], "ns")
        res2 = qp.find_similar_batch(q, 10, "ns", "l2")
        out.append((ids, res, res2, launched, qp.cert_tier_counts("ns"), qp._cert_mode))
    (_, c1, c2, _, ccpu, _), (_, g1, g2, launched, cgpu, mode) = out
    assert launched == 3 and ccpu == cgpu and mode == {}
    assert not any(t.startswith("light_") for t in cgpu)
    for a, b in [(c1[m], g1[m]) for m in c1] + [(c2, g2)]:
        for ra, rb in zip(a, b):
            assert {r["id"] for r in ra} == {r["id"] for r in rb}
            np.testing.assert_allclose(sorted(r["score"] for r in ra),
                                       sorted(r["score"] for r in rb), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["int8", "int8_no_resid", "float32"])
def test_bf16_store_mirrors_engine_on_cuda_matches_cpu(cuda, kind):
    """A bf16 store with an int8 or f32 mirror (its rows written, so the mirror holds the
    written values): the CPU's ids, scores within 1e-4 and tiers, B3 over the mirror's
    type and B2 over the bf16 rows launched once a search, never a light_ tier."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((20000, 128), dtype=np.float32)
    q = [VectorDTO(v) for v in rng.standard_normal((16, 128), dtype=np.float32)]
    cfg = EngineConfig(dtype="bfloat16", sweep_dtype=kind.split("_")[0],
                       sweep_resid=kind != "int8_no_resid")
    counter = "launches_f32" if kind == "float32" else "launches_int8"
    out = []
    for device in ("cpu", cuda):
        qp = QueryProcessor(cfg, device=device)
        ids = qp.bulk_load(x, "ns", ids=None if not out else out[0][0])
        st = qp.storage.namespace("ns").device_state()
        assert st.mirror is not st.data and st.data.dtype == torch.bfloat16
        b3, b2 = (getattr(fused_knn_t._window_mins_t, counter),
                  fused_knn_t._gather_score.launches_bf16)
        res = {m: qp.find_similar_batch(q, 10, "ns", m) for m in ("l2", "ip", "cosine")}
        launched = (getattr(fused_knn_t._window_mins_t, counter) - b3,
                    fused_knn_t._gather_score.launches_bf16 - b2)
        qp.delete(ids[::50], "ns")
        res2 = qp.find_similar_batch(q, 10, "ns", "l2")
        out.append((ids, res, res2, launched, qp.cert_tier_counts("ns")))
    (_, c1, c2, _, ccpu), (_, g1, g2, launched, cgpu) = out
    assert launched == (3, 3) and ccpu == cgpu
    assert not any(t.startswith("light_") for t in cgpu)
    for a, b in [(c1[m], g1[m]) for m in c1] + [(c2, g2)]:
        for ra, rb in zip(a, b):
            assert {r["id"] for r in ra} == {r["id"] for r in rb}
            np.testing.assert_allclose(sorted(r["score"] for r in ra),
                                       sorted(r["score"] for r in rb), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["int8", "int8_no_resid", "float32"])
def test_bf16_store_certificate_gap_on_cuda_matches_cpu(cuda, kind):
    """ROADMAP C13's construction (tests/test_torch_bf16_mirrors.py, l2): row A's written
    value ranks behind 40 decoys, its stored bf16 row is the query's nearest.  The card
    returns the CPU's answer, the exact set over the stored rows with A first, at the
    CPU's tier."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((8192, 128)) + 8).astype(np.float32)
    x[100] = np.float32(1.5) + np.float32(2.0 ** -8 - 2.0 ** -14)
    for i, r in enumerate(range(1000, 1000 + 40 * 64, 64)):
        x[r] = 1.5
        x[r, i % 128] = np.float32(1.5 + (7 + i if i < 16 else 30) / 128)
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    q = [VectorDTO(np.ones(128, np.float32))]
    cfg = EngineConfig(dtype="bfloat16", sweep_dtype=kind.split("_")[0],
                       sweep_resid=kind != "int8_no_resid")
    out = []
    for device in ("cpu", cuda):
        qp = QueryProcessor(cfg, device=device)
        qp.bulk_load(x, "ns", ids=ids)
        res = qp.find_similar_batch(q, 10, "ns", "l2")[0]
        out.append(({r["id"] for r in res}, res[0]["id"], qp.cert_tier_counts("ns")))
    b = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    want = {ids[i] for i in np.argsort(((b - 1.0) ** 2).sum(1), kind="stable")[:10]}
    assert out[0] == out[1] and out[1][0] == want and out[1][1] == ids[100]


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_bf16_store_f32_mirror_sharded_on_cuda_matches_cpu(cuda, metric):
    """A (2, 2) distributed engine on [cuda:0] * 4 over a bf16 store with an f32 mirror
    (each cell's own): the CPU's answers, B3 over f32 and B2 over bf16 rows once a shard
    of each replica holding a live query."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((40000, 96), dtype=np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    q = [VectorDTO(v) for v in rng.standard_normal((40, 96), dtype=np.float32)]
    cfg = EngineConfig(dtype="bfloat16", sweep_dtype="float32")
    want, _ = _sharded_answers([torch.device("cpu")] * 4, cfg, x, ids, q, 2, 2, metric)
    b3 = fused_knn_t._window_mins_t.launches_f32
    got, launched = _sharded_answers([cuda] * 4, cfg, x, ids, q, 2, 2, metric)
    _same_sharded_answers(got, want)
    assert launched == [0, 4, 4] and fused_knn_t._window_mins_t.launches_f32 - b3 >= 4


# ------------------------------------------------------------------ B7: the int8 probe


@pytest.mark.parametrize("b", [64, 128])
def test_int8_probe_kernels_match_plain(cuda, b):
    from mlvectordb_tpu_torch.probes import int8_mma

    rng = np.random.default_rng(31 + b)
    data = torch.from_numpy(rng.standard_normal((65536, 128), dtype=np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((b, 128), dtype=np.float32)).to(cuda)
    codes = fused_knn_t.quantize_int8_rows(data)[0]
    q8, qh = int8_mma.quantize_queries(q), q.to(torch.bfloat16)
    before = (int8_mma.mma_min.launches, int8_mma.stream_sum.launches)
    got = (int8_mma.convert_mma_min(qh, codes), int8_mma.mma_min(q8, codes),
           int8_mma.stream_sum(codes, b))
    torch.cuda.synchronize()
    assert (int8_mma.mma_min.launches, int8_mma.stream_sum.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    want = (int8_mma.convert_mma_min_ref(qh, codes), int8_mma.mma_min_ref(q8, codes),
            int8_mma.stream_sum_ref(codes, b))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (16, b, 128) and g.dtype == w.dtype
    # kA is B3's int8 one pass on the tensor cores: within its phase-1 budget; kB and kC
    # are exact integers
    budget = fused_knn_t._phase1_budget(qh, None, codes, None, None, None, None, r1=32)
    _close_slack(got[0], want[0], budget)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


# ------------------------------------------------------------------ bf16 storage (B4/B5/B2/B1)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("r1", [8, 32])
@pytest.mark.parametrize("b", [8, 512])
def test_bf16_rows_kernels_match_plain(cuda, metric, r1, b):
    """B4/B5 over bf16 rows and a bf16-rounded query (carried as f32): every product is
    exact, so the kernel (tensor-core sums) and its plain version (f32 sums) differ only
    in how they sum: within the budget."""
    rng = np.random.default_rng(r1 * 1000 + b + 3)
    n = 65536
    data = torch.from_numpy(rng.standard_normal((n, 128), dtype=np.float32)).to(cuda)
    rows = data.to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((b, 128), dtype=np.float32)).to(cuda)
    qt = q.T.to(torch.bfloat16).float().contiguous()
    qn = (q * q).sum(-1)[None, :].contiguous()
    kw = dict(metric=metric, db_tile=fused_knn.DB_TILE, r1=r1)
    hw = n - fused_knn.DB_TILE - 1234
    before = (fused_knn._window_mins_fast.launches_bf16,
              fused_knn._window_mins_masked.launches_bf16)
    got = fused_knn._window_mins_fast(rows, qt, qn, hw, **kw)
    valid = torch.from_numpy(rng.random(n) > 0.01).to(cuda)
    valid[-fused_knn.DB_TILE:] = False
    maskadd = torch.where(valid, 0.0, float(MASKED))
    bias = ((data * data).sum(-1) + maskadd if metric == "l2" else maskadd)[:, None].contiguous()
    got_m = fused_knn._window_mins_masked(rows, qt, qn, bias, **kw)
    torch.cuda.synchronize()
    assert (fused_knn._window_mins_fast.launches_bf16,
            fused_knn._window_mins_masked.launches_bf16) == (before[0] + 1, before[1] + 1)
    _close(got, fused_knn._window_mins_fast_ref(rows, qt, qn, hw, **kw),
           fused_knn._phase1_budget(rows, qt, qn, hw=hw, **kw))
    _close(got_m, fused_knn._window_mins_masked_ref(rows, qt, qn, bias, **kw),
           fused_knn._phase1_budget(rows, qt, qn, bias=bias, **kw))


@pytest.mark.parametrize("d", [128, 384, 1536])
@pytest.mark.parametrize("r1", [32, 16, 8, 4])
def test_gather_score_bf16_rows_match_plain(cuda, r1, d):
    q, rows, f = _gather_operands(cuda, torch.bfloat16, r1, d, r1 + d + 40,
                                  cap=65536 if d == 128 else 16384)
    before = fused_knn_t._gather_score.launches_bf16
    got = fused_knn_t._gather_score(q, rows, f, r1=r1)
    torch.cuda.synchronize()
    assert fused_knn_t._gather_score.launches_bf16 == before + 1
    _check_gather(q, rows, f, r1, got)


@pytest.mark.parametrize("n", [1, 5, 127, 128, 200])
@pytest.mark.parametrize("d", [128, 1536])
@pytest.mark.parametrize("rows", [torch.float32, torch.bfloat16])
def test_gather_score_live_launch_bit_equal_to_full(cuda, rows, d, n):
    """B = 256 with the engine's padding from ``n`` on (zero queries over one row's
    windows): the launch over the live rows and the first padded one, with its outputs
    copied to the rest, equals the full launch bit for bit."""
    q, data, f = _gather_operands(cuda, rows, 16, d, n + d, b=256, s1=40, cap=16384)
    q[n:] = 0.0
    f[n:] = f[n]
    c = fused_knn_t._gather_score
    full = c(q, data, f, r1=16)
    before = c.rows
    live = c(q, data, f, r1=16, n_live=n)
    torch.cuda.synchronize()
    assert c.rows - before == (n + 1) * 40 * 16
    for g, w in zip(live, full):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_gather_score_rejects_misaligned_rows(cuda):
    q, data, f = _gather_operands(cuda, torch.float32, 4, 128, 3, b=8, s1=5, cap=4096)
    with pytest.raises(ValueError):
        fused_knn_t._gather_score(q, data.view(-1)[1:1 + 4092 * 128].view(4092, 128), f, r1=4)


@pytest.mark.parametrize("cfg", [dict(sweep_dtype="bfloat16"), dict(sweep_dtype="int8"),
                                 dict(sweep_dtype="float32"),
                                 dict(dtype="bfloat16", sweep_dtype="bfloat16"),
                                 dict(dtype="bfloat16", sweep_dtype="int8"),
                                 dict(dtype="bfloat16", sweep_dtype="float32")],
                         ids=["bf16", "int8", "f32", "bf16_store", "bf16_store_int8",
                              "bf16_store_f32"])
@pytest.mark.parametrize("k", [10, 100])
def test_engine_rescan_live_rows_match_all_rows(cuda, monkeypatch, cfg, k):
    """The engine's searches (B = 100 in the 512 bucket: the live count reaches B2) give
    the same ids, distances, tiers and transfers when B2 computes every row."""
    rng = np.random.default_rng(k + len(cfg))
    x = rng.standard_normal((65536, 128), dtype=np.float32)
    q = [VectorDTO(v) for v in rng.standard_normal((100, 128), dtype=np.float32)]
    out = []
    for live in (True, False):
        real = fused_knn_t._gather_score
        seen = []

        def spy(q32, data, f, *, r1, n_live=None):
            seen.append(n_live)
            return real(q32, data, f, r1=r1, n_live=n_live if live else None)

        spy.__dict__.update(real.__dict__)     # the wrapper counts on the module's name
        monkeypatch.setattr(fused_knn_t, "_gather_score", spy)
        qp = QueryProcessor(EngineConfig(**cfg), device=cuda)
        ids = qp.bulk_load(x, "ns", ids=None if not out else out[0][0])
        qp.delete(ids[::97], "ns")
        x0 = dict(qp.transfer_counts)
        res = [qp.find_similar_batch(q, k, "ns", metric) for metric in ("l2", "ip", "cosine")]
        xfer = (qp.transfer_counts["h2d"] - x0["h2d"], qp.transfer_counts["d2h"] - x0["d2h"])
        monkeypatch.setattr(fused_knn_t, "_gather_score", real)
        real.__dict__.update(spy.__dict__)
        assert seen and seen[0] == 100
        out.append((ids, res, xfer, qp.cert_tier_counts("ns")))
    (_, r_live, x_live, t_live), (_, r_all, x_all, t_all) = out
    assert x_live == x_all and t_live == t_all
    for a, b in zip(r_live, r_all):
        for ra, rb in zip(a, b):
            assert [r["id"] for r in ra] == [r["id"] for r in rb]
            assert [r["score"] for r in ra] == [r["score"] for r in rb]


def _same_dtype_operands(dev, n, b, metric, seed, n_live=None):
    """Kernel B1's operands for the same-dtype sweep (a bf16 store's rows as the mirror):
    one pass, the bound row sqrt(sqn) scaled by |qres| for l2/ip, none for cosine;
    queries from ``n_live`` on are the engine's zero padding."""
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.standard_normal((n, 128), dtype=np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, 128), dtype=np.float32)).to(dev)
    if n_live is not None:
        q[n_live:] = 0.0
    valid = torch.from_numpy(rng.random(n) > 0.01).to(dev)
    valid[-fused_knn_t.SWEEP_TILE:] = False
    rows = data.to(torch.bfloat16)
    _, wb, tags, _ = fused_knn_t._plan(certify=True, light=False, metric=metric,
                                       mirror_dtype=torch.bfloat16,
                                       rescan_dtype=torch.bfloat16, sweep_err=None,
                                       resid=None, rscale=None, err1=None, rscale2=None)
    prep = fused_knn_t._prep_terms(valid, (data * data).sum(-1), n, None, None, None, cap=n,
                                   metric=metric, masked=True, use_resid=False,
                                   wb_sources=wb, rows=rows)
    qh, qres, qres_f32 = fused_knn_t._fold_query(q, metric, False, torch.bfloat16, mixed=False)
    assert qres is None
    scales = {"qres": torch.linalg.vector_norm(qres_f32, dim=1), "one": torch.ones(b, device=dev),
              "qh": torch.linalg.vector_norm(q, dim=1) * (2.0 if metric == "l2" else 1.0)}
    qe = torch.stack([scales[t] for t in tags], 1).contiguous() if wb else None
    args = (qh, None, rows, None, None, prep["scale_row"], prep["bias_row"])
    qn = torch.linalg.vector_norm(q, dim=1) * (2.0 if metric == "l2" else 1.0)
    slack = 128 * 2.0 ** -22 * qn * (1.0 if metric == "cosine" else prep["maxd"])
    return args, dict(qe=qe, eb_rows=prep["eb_rows"]), slack


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("r1", [32, 16, 4])
@pytest.mark.parametrize("b", [8, 132])
def test_same_dtype_sweep_kernel_matches_plain(cuda, metric, r1, b):
    """B1 over a bf16 store's own rows, tile-major (with the block mins at r1 = 32) and in
    the [B, P] form: each within the slack of its plain version, the two forms bit-equal
    at the positions they share."""
    args, kw, slack = _same_dtype_operands(cuda, 65536, b, metric, r1 * 7 + b)
    c = fused_knn_t._window_mins_t
    before = (c.launches, c.launches_heavy, c.launches_bp)
    got, bm, _ = c(*args, r1=r1, emit_block_mins=r1 == 32, **kw)
    bp = fused_knn_t._window_mins_t(*args, r1=r1, transposed=False, **kw)[0]
    torch.cuda.synchronize()
    c = fused_knn_t._window_mins_t
    assert (c.launches, c.launches_heavy, c.launches_bp) == (before[0] + 2, before[1],
                                                             before[2] + 1)
    want, want_bm, _ = fused_knn_t._window_mins_t_ref(*args, r1=r1, emit_block_mins=r1 == 32,
                                                      **kw)
    budget = _budget(args, kw, r1)
    assert bool((budget <= slack[None, :, None]).all())
    _close_slack(got, want, budget)
    assert bool((want == MASKED).any())
    if r1 == 32:
        _close_slack(bm, want_bm, budget.amax(-1))
    want_bp = fused_knn_t._window_mins_t_ref(*args, r1=r1, transposed=False, **kw)[0]
    assert bp.shape == want_bp.shape == (b, 65536 // r1)
    _close_slack(bp, want_bp, _budget(args, kw, r1, transposed=False))
    assert torch.equal(bp.reshape(b, -1, (32 // r1) * 128).permute(1, 0, 2), got)


@pytest.mark.parametrize("sweep", [None, "bfloat16"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_bf16_engine_on_cuda_matches_cpu(cuda, sweep, metric):
    """A bf16 store row-major (B4/B5 over bf16 rows) and with the same-dtype sweep (B1
    one pass, B2 over bf16 rows): the same ids and tiers on the card as on the CPU."""
    rng = np.random.default_rng(37)
    x = rng.standard_normal((20000, 128), dtype=np.float32)
    q = [VectorDTO(v) for v in rng.standard_normal((16, 128), dtype=np.float32)]
    cfg = EngineConfig(dtype="bfloat16", sweep_dtype=sweep)
    counters = ((fused_knn._window_mins_fast, "launches_bf16"),
                (fused_knn._window_mins_masked, "launches_bf16"),
                (fused_knn_t._window_mins_t, "launches"),
                (fused_knn_t._window_mins_t, "launches_heavy"),
                (fused_knn_t._gather_score, "launches_bf16"))
    out = []
    for device in ("cpu", cuda):
        qp = QueryProcessor(cfg, device=device)
        ids = qp.bulk_load(x, "ns", ids=None if not out else out[0][0])
        st = qp.storage.namespace("ns").device_state()
        assert st.data.dtype == torch.bfloat16 and (st.mirror is st.data) == (sweep is not None)
        before = [getattr(fn, a) for fn, a in counters]
        res = qp.find_similar_batch(q, 10, "ns", metric)
        qp.delete(ids[::50], "ns")
        res2 = qp.find_similar_batch(q, 10, "ns", metric)
        launched = [getattr(fn, a) - v for (fn, a), v in zip(counters, before)]
        out.append((ids, res, res2, launched, qp.cert_tier_counts("ns")))
    (_, c1, c2, _, ccpu), (_, g1, g2, launched, cgpu) = out
    assert launched == ([1, 1, 0, 0, 0] if sweep is None else [0, 0, 2, 0, 2])
    assert ccpu == cgpu == ({} if sweep is None else {"fast": 2})
    for a, b in ((c1, g1), (c2, g2)):
        for ra, rb in zip(a, b):
            assert {r["id"] for r in ra} == {r["id"] for r in rb}
            np.testing.assert_allclose(sorted(r["score"] for r in ra),
                                       sorted(r["score"] for r in rb), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("r1", [32, 4])
def test_out_layout_probe_matches_plain(cuda, r1):
    """Probe B6 at 2^18 rows: both layouts equal to their plain versions within the
    slack, and to each other bit for bit."""
    from mlvectordb_tpu_torch.probes import out_layout

    rng = np.random.default_rng(43 + r1)
    rows = torch.from_numpy(rng.standard_normal((1 << 18, 128), dtype=np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((128, 128), dtype=np.float32)).to(cuda)
    ops = out_layout.operands(rows, q)
    a, c = out_layout.out_2d(*ops, r1), out_layout.out_3d(*ops, r1)
    torch.cuda.synchronize()
    assert torch.equal(out_layout.as_tile_major(a, r1), c)
    slack = 128 * 2.0 ** -22 * torch.linalg.vector_norm(q, dim=1) * rows.to(
        torch.bfloat16).float().norm(dim=1).max()
    _close_slack(a, out_layout.out_2d_ref(*ops, r1), slack[:, None])
    _close_slack(c, out_layout.out_3d_ref(*ops, r1), slack[None, :, None])


# ------------------------------------------------------------------ live columns (B1/B3)


@pytest.mark.parametrize("n", [1, 5, 64, 127, 128, 200])
@pytest.mark.parametrize("outputs", ["block_mins", "pool", "pool_only", "bp"])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("program", ["light", "heavy", "int8_two_pass", "int8_resid", "f32",
                                     "same_dtype"])
def test_live_tile_launch_bit_equal_to_full(cuda, program, metric, outputs, n):
    """A launch of the live columns (the zero-padded ones filled from the cached
    zero-query column) equals the full launch of the same kernel bit for bit on every
    column: each column is computed on its own.  The block mins and the pool are the
    kernel's own mins' min and pool."""
    b = 256
    if program == "same_dtype":
        args, kw, _ = _same_dtype_operands(cuda, 16384, b, metric, n, n_live=n)
    else:
        args, kw, _ = _sweep_operands(cuda, 16384, b, metric, program, n, n_live=n)
    opts = {"block_mins": dict(r1=32, emit_block_mins=True), "pool": dict(r1=16, emit_topm=8),
            "pool_only": dict(r1=16, emit_topm=8, skip_wm=True),
            "bp": dict(r1=32, transposed=False)}[outputs]
    fn = fused_knn_t._window_mins_t
    full = fn(*args, **kw, **opts)
    before = (fn.launches, fn.cols, fn.launches_zero)
    cache = {}
    live = fn(*args, **kw, **opts, n_live=n, zero_cache=cache)
    again = fn(*args, **kw, **opts, n_live=n, zero_cache=cache)
    torch.cuda.synchronize()
    n_c = fused_knn_t._live_columns(b, n)
    assert (fn.launches, fn.cols, fn.launches_zero) == (before[0] + 2, before[1] + 2 * n_c,
                                                        before[2] + 1)
    for f, g, a in zip(full, live, again):
        assert (f is None) == (g is None)
        if f is not None:
            assert torch.equal(_bits(g), _bits(f)) and torch.equal(_bits(a), _bits(f))
    own = full[0] if full[0] is not None else fn(*args, **kw, r1=opts["r1"])[0]
    if opts.get("emit_block_mins"):
        assert torch.equal(_bits(full[1]), _bits(own.amin(-1)))
    if opts.get("emit_topm"):
        assert torch.equal(_bits(full[2]), _bits(fused_knn_t._topm_pool_ref(own, 8)))


@pytest.mark.parametrize("kind", ["gaussian", "hard", "int8_extremes"])
def test_tensor_core_dots_within_the_bar(cuda, kind):
    """The tensor-core body's dots against float64: max |dot - exact| / (|qh| |x|) at
    most Dp * 2^-23 (the kernel's note bounds it by Dp * (1 + 1/s) * 2^-23)."""
    from mlvectordb_tpu_torch.probes import tc_error

    rng = np.random.default_rng(47)
    n, b = 16384, 128
    if kind == "gaussian":
        rows = torch.from_numpy(rng.standard_normal((n, 128), dtype=np.float32)).to(
            torch.bfloat16)
        qh = torch.from_numpy(rng.standard_normal((b, 128), dtype=np.float32)).to(torch.bfloat16)
    elif kind == "hard":
        rows, qh = tc_error.hard_rows(rng, n, 128), tc_error.hard_queries(rng, b, 128)
    else:
        rows = tc_error.int8_extremes(rng, n, 128)
        qh = tc_error.hard_queries(rng, b, 128)
    err = tc_error.max_rel_err(qh.to(cuda), rows.to(cuda))
    assert 0.0 <= err <= 128 * 2.0 ** -23, err


# ------------------------------------------------------------------ B4/B5: live columns, tensor cores


def _row_operands(dev, rows, metric, bucket, n_live, seed, d=128, n=65536):
    """B4/B5's operands as exact_knn_fused builds them for a batch of ``n_live`` queries
    padded with zero rows to ``bucket`` (the query rounded to the rows' type), ~1%
    tombstones and a dead last tile in B5's bias: (data, qt, qn, hw, bias, kw)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
    q = torch.zeros((bucket, d), device=dev)
    q[:n_live] = torch.from_numpy(rng.standard_normal((n_live, d), dtype=np.float32)).to(dev)
    qt = q.T.to(rows).float().contiguous()
    qn = (q * q).sum(-1)[None, :].contiguous()
    valid = torch.from_numpy(rng.random(n) > 0.01).to(dev)
    valid[-fused_knn.DB_TILE:] = False
    maskadd = torch.where(valid, 0.0, float(MASKED))
    bias = ((x * x).sum(-1) + maskadd if metric == "l2" else maskadd)[:, None].contiguous()
    kw = dict(metric=metric, db_tile=fused_knn.DB_TILE, r1=fused_knn._pick_r1(bucket, n, 16))
    return x.to(rows), qt, qn, n - 1234, bias, kw


@pytest.mark.parametrize("metric,bucket,n_live", [("l2", 512, 128), ("ip", 64, 16),
                                                  ("cosine", 64, 16), ("l2", 512, 5)])
@pytest.mark.parametrize("variant", ["fast", "masked"])
@pytest.mark.parametrize("rows", [torch.float32, torch.bfloat16])
def test_row_live_launch_bit_equal_to_full(cuda, rows, variant, metric, bucket, n_live):
    """At the engine's operand sets of the row-major path (l2 at B = 128 in the 512 bucket,
    ip and cosine at B = 16 in the 64 bucket; before the deletes the fast kernel, after
    them the masked one): a launch of the live columns (n_live rounded up to 8) equals the
    same columns of the full launch bit for bit, and counts those columns."""
    data, qt, qn, hw, bias, kw = _row_operands(cuda, rows, metric, bucket, n_live, n_live)
    fn = fused_knn._window_mins_fast if variant == "fast" else fused_knn._window_mins_masked
    arg = hw if variant == "fast" else bias
    full = fn(data, qt, qn, arg, **kw)
    before = (fn.launches, fn.cols)
    live = fn(data, qt, qn, arg, **kw, n_live=n_live)
    torch.cuda.synchronize()
    n_c = -(-n_live // 8) * 8
    assert live.shape == (data.shape[0] // kw["r1"], n_c)
    assert (fn.launches, fn.cols) == (before[0] + 1, before[1] + n_c)
    assert torch.equal(live.view(torch.int32), full[:, :n_c].view(torch.int32))


@pytest.mark.parametrize("d", [384, 1408, 1536])
@pytest.mark.parametrize("bucket,n_live", [(512, 128), (64, 16)])
@pytest.mark.parametrize("rows", [torch.float32, torch.bfloat16])
def test_wide_dims_kernels_match_plain(cuda, rows, bucket, n_live, d):
    """Past the chunks of the query tile that stay in shared memory (f32 rows past Dp =
    128, bf16 rows past 512) the kernel streams them, one per stage: at Dp = 384, 1408 and
    1536, B4 and B5 (l2, ip, cosine) stay within the per-element budget of their plain
    versions, and a launch of the live columns is bit-equal to the full launch's."""
    for metric in ("l2", "ip", "cosine"):
        data, qt, qn, hw, bias, kw = _row_operands(cuda, rows, metric, bucket, n_live, d,
                                                   d=d, n=16384)
        for fn, ref, arg, side in (
                (fused_knn._window_mins_fast, fused_knn._window_mins_fast_ref, hw, {"hw": hw}),
                (fused_knn._window_mins_masked, fused_knn._window_mins_masked_ref, bias,
                 {"bias": bias})):
            full = fn(data, qt, qn, arg, **kw)
            live = fn(data, qt, qn, arg, **kw, n_live=n_live)
            torch.cuda.synchronize()
            _close(full, ref(data, qt, qn, arg, **kw),
                   fused_knn._phase1_budget(data, qt, qn, **side, **kw))
            n_c = -(-n_live // 8) * 8
            assert torch.equal(live.view(torch.int32), full[:, :n_c].view(torch.int32))


@pytest.mark.parametrize("kind", ["f32_gaussian", "f32_hard", "bf16_gaussian", "bf16_hard"])
def test_b4_tensor_core_dots_within_the_bar(cuda, kind):
    """B4's dots against float64 (f32 rows: the six products of the split; bf16 rows:
    one pass): max |dot - exact| / (|q| |x|) at most Dp * 2^-23."""
    from mlvectordb_tpu_torch.probes import tc_error

    rng = np.random.default_rng(53)
    n, b = 16384, 128
    if kind.endswith("gaussian"):
        q = torch.from_numpy(rng.standard_normal((b, 128), dtype=np.float32)) * 64
        x = torch.from_numpy(rng.standard_normal((n, 128), dtype=np.float32)) * 64
    else:
        q, x = tc_error.hard_queries_f32(rng, b, 128), tc_error.hard_rows_f32(rng, n, 128)
    if kind.startswith("bf16"):
        x = x.to(torch.bfloat16)
    err = tc_error.b4_max_rel_err(q.to(cuda), x.to(cuda))
    assert 0.0 <= err <= 128 * 2.0 ** -23, err


@pytest.mark.parametrize("kind", ["f32_gaussian", "f32_hard", "bf16_hard"])
def test_b4_tensor_core_dots_within_the_bar_at_dp_1536(cuda, kind):
    """The same at Dp = 1536, where the kernel streams its query chunks: max |dot - exact|
    / (|q| |x|) at most Dp * 2^-23."""
    from mlvectordb_tpu_torch.probes import tc_error

    rng = np.random.default_rng(59)
    n, b, d = 8192, 128, 1536
    if kind.endswith("gaussian"):
        q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)) * 64
        x = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)) * 64
    else:
        q, x = tc_error.hard_queries_f32(rng, b, d), tc_error.hard_rows_f32(rng, n, d)
    if kind.startswith("bf16"):
        x = x.to(torch.bfloat16)
    err = tc_error.b4_max_rel_err(q.to(cuda), x.to(cuda))
    assert 0.0 <= err <= d * 2.0 ** -23, err


# ------------------------------------------------------------------ filtered (hybrid) search


@pytest.mark.parametrize("cfg", [{}, {"dtype": "bfloat16"}, {"sweep_dtype": "bfloat16"},
                                 {"sweep_dtype": "int8"},
                                 {"dtype": "bfloat16", "sweep_dtype": "bfloat16"}])
def test_filtered_engine_on_cuda_matches_cpu(cuda, cfg):
    """Filtered searches (half the rows, 3 rows, none) at k = 10 and 100, before and after
    deletes: the same ids and tiers on the card as on the CPU, B5 (row-major) or B1 over a
    masked bias row and B2 (sweep) launched, no hit outside its filter."""
    rng = np.random.default_rng(23)
    n = 20000
    x = rng.standard_normal((n, 128), dtype=np.float32)
    metas = [{"p": i % 2, "r": int(v)} for i, v in enumerate(rng.permutation(n))]
    q = [VectorDTO(v) for v in rng.standard_normal((16, 128), dtype=np.float32)]
    specs = ({"p": 0}, {"r": {"$lt": 3}}, {"r": -1})
    sweep = cfg.get("sweep_dtype") is not None
    out = []
    for device in ("cpu", cuda):
        qp = QueryProcessor(EngineConfig(**cfg), device=device)
        ids = qp.bulk_load(x, "ns", ids=None if not out else out[0][0], metadatas=metas)
        before = (fused_knn._window_mins_masked.launches, fused_knn_t._window_mins_t.launches,
                  fused_knn_t._gather_score.launches)
        res = []
        for when in ("fresh", "deleted"):
            if when == "deleted":
                qp.delete(ids[::50], "ns")
            for k in (10, 100):
                for spec in specs:
                    res.append(qp.find_similar_batch(q, k, "ns", "l2", filter=spec))
        launched = (fused_knn._window_mins_masked.launches - before[0],
                    fused_knn_t._window_mins_t.launches - before[1],
                    fused_knn_t._gather_score.launches - before[2])
        out.append((ids, res, launched, qp.cert_tier_counts("ns")))
    (_, cres, _, ccpu), (_, gres, launched, cgpu) = out
    assert ccpu == cgpu
    assert (launched[1] > 0 and launched[2] > 0) if sweep else launched[0] > 0
    for a, b, spec in zip(cres, gres, specs * 4):
        for ra, rb in zip(a, b):
            assert {r["id"] for r in ra} == {r["id"] for r in rb}
            assert all(r["metadata"]["p"] == 0 for r in rb) if spec == {"p": 0} else True
            np.testing.assert_allclose(sorted(r["score"] for r in ra),
                                       sorted(r["score"] for r in rb), rtol=1e-4, atol=1e-4)


def test_filtered_searches_race_writes_on_cuda(cuda):
    """tests/test_torch_concurrency.py's race on the card: Python threads on one stream."""
    from .test_torch_concurrency import _race

    _race({"sweep_dtype": "bfloat16"}, cuda, n0=8200)


# ---- durability and operations on the card (chip_smoke.py phase 16 at a small size) ----

_DUR_N, _DUR_D = 20_000, 128


def _dur_store(cuda):
    """A bf16-mirror namespace of 20,000 gaussian rows on the card, 200 of them deleted
    (capacity 32,768: the certified sweep serves it)."""
    rng = np.random.default_rng(16)
    x = rng.standard_normal((_DUR_N, _DUR_D), dtype=np.float32)
    qp = QueryProcessor(EngineConfig(sweep_dtype="bfloat16"), device=cuda)
    ids = qp.bulk_load(x, "ns")
    qp.delete(ids[:200], "ns")
    q = [VectorDTO(v) for v in rng.standard_normal((128, _DUR_D), dtype=np.float32)]
    return rng, x, ids, qp, q


def _answers(qp, q, k):
    return [{r["id"]: r["score"] for r in rs} for rs in qp.find_similar_batch(q, k, "ns", "l2")]


def _same_answers(a, b):
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        np.testing.assert_allclose([rb[i] for i in ra], list(ra.values()), rtol=1e-6)


def _oracle_sets(rows, q, k):
    """Each query's k nearest row indices (float64 brute force, l2)."""
    qq = np.stack([v.values for v in q]).astype(np.float64)
    r = rows.astype(np.float64)
    d = (qq * qq).sum(1)[:, None] + (r * r).sum(1)[None, :] - 2 * qq @ r.T
    return [set(np.argsort(row, kind="stable")[:k].tolist()) for row in d]


def test_snapshot_round_trip_on_cuda(cuda, tmp_path):
    _, x, ids, qp, q = _dur_store(cuda)
    want = {k: _answers(qp, q, k) for k in (10, 100)}
    qp.save(str(tmp_path / "snap"))
    loaded = QueryProcessor.load(str(tmp_path / "snap"), qp.config, device=cuda)
    src, dst = qp.storage.namespace("ns"), loaded.storage.namespace("ns")
    assert dst.nbytes == src.nbytes and dst.live_count == src.live_count == _DUR_N - 200
    assert dst.device_state().data.device.type == "cuda"
    before = (fused_knn_t._window_mins_t.launches, fused_knn_t._gather_score.launches)
    x0 = dict(loaded.transfer_counts)
    got10 = _answers(loaded, q, 10)
    assert (loaded.transfer_counts["h2d"] - x0["h2d"],
            loaded.transfer_counts["d2h"] - x0["d2h"]) == (1, 1)
    assert loaded.cert_tier_counts("ns") == {"light_fast": 1}
    assert (fused_knn_t._window_mins_t.launches > before[0]
            and fused_knn_t._gather_score.launches > before[1])
    _same_answers(want[10], got10)
    _same_answers(want[100], _answers(loaded, q, 100))
    live = np.arange(200, _DUR_N)
    for rs, want_rows in zip(got10, _oracle_sets(x[live], q, 10)):
        assert set(rs) == {ids[200 + i] for i in want_rows}


def test_wal_crash_recovery_on_cuda(cuda, tmp_path):
    rng, x, ids, qp, q = _dur_store(cuda)
    snap, wal = str(tmp_path / "snap"), str(tmp_path / "wal")
    qp.save(snap)
    live = QueryProcessor.load(snap, qp.config, wal_path=wal, wal_fsync=True, device=cuda)
    new = rng.standard_normal((1000, _DUR_D), dtype=np.float32)
    added = []
    for lo in range(0, 1000, 100):
        added += live.upsert_many([VectorDTO(v, {"b": lo}) for v in new[lo:lo + 100]], "ns")
    gone = ids[200:300]
    assert len(live.delete(gone, "ns")) == 100
    over = rng.standard_normal((10, _DUR_D), dtype=np.float32)
    live.upsert_many([VectorDTO(v, {"over": True}, id=ids[500 + i]) for i, v in enumerate(over)],
                     "ns")
    want = _answers(live, q, 10)
    del live   # abandoned: no save, no close
    rec = QueryProcessor.load(snap, qp.config, wal_path=wal, device=cuda)
    assert rec.get_namespace_count("ns") == _DUR_N - 300 + 1000
    for v in added[::37]:
        got = rec.storage.read(v.id, "ns")
        np.testing.assert_array_equal(got.values, v.values)
        assert got.metadata == v.metadata
    for i, v in enumerate(over):
        np.testing.assert_array_equal(rec.storage.read(ids[500 + i], "ns").values, v)
    assert all(rec.storage.read(vid, "ns") is None for vid in gone)
    _same_answers(want, _answers(rec, q, 10))


def test_offload_frees_device_memory_on_cuda(cuda):
    _, _, _, qp, q = _dur_store(cuda)
    want = _answers(qp, q, 10)
    ns = qp.storage.namespace("ns")
    nbytes = ns.nbytes
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    assert qp.offload_namespace("ns")
    assert before - torch.cuda.memory_allocated() >= 0.9 * nbytes
    assert qp.get_storage_info()["offloaded_namespaces"] == ["ns"]
    qp._result_cache.clear()
    _same_answers(want, _answers(qp, q, 10))
    assert not ns.offloaded and ns.nbytes == nbytes


def test_operations_on_cuda(cuda, tmp_path):
    from mlvectordb_tpu_torch.utils.capacity import plan_capacity
    from mlvectordb_tpu_torch.utils.health import deep_health
    from mlvectordb_tpu_torch.utils.metrics import render_metrics
    from mlvectordb_tpu_torch.utils.tracing import PROFILER, RECORDER

    _, _, _, qp, q = _dur_store(cuda)
    before = (fused_knn_t._window_mins_t.launches, fused_knn_t._gather_score.launches)
    count, report = qp.warmup("ns", detail=True)
    assert count == len(report) == 3 * 2 * 2 * 2     # buckets x k x metric x variant
    assert fused_knn_t._window_mins_t.launches - before[0] >= count
    qp.find_similar_batch(q, 10, "ns")
    assert qp.get_statistics()["exactness"]["tiers_by_namespace"] == {"ns": {"light_fast": 1}}
    assert qp.explain_query(q[0], 10, "ns")["certificate_dispatch"] == "light"
    health = deep_health(qp)
    assert health["status"] == "healthy" and health["device"]["platform"] == "gpu"
    assert health["device"]["devices"][0] == torch.cuda.get_device_name(0)
    text = render_metrics(qp, RECORDER)
    assert 'vectordb_device_memory_bytes{kind="in_use"}' in text
    plan = plan_capacity(100_000_000, 1536, EngineConfig(dtype="bfloat16",
                                                         sweep_dtype="bfloat16"))
    assert plan.hbm_per_chip == torch.cuda.get_device_properties(0).total_memory
    PROFILER.start(str(tmp_path / "prof"))
    qp.find_similar_batch(q[:8], 10, "ns", "cosine")
    path = PROFILER.stop()
    import json

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    assert any(e.get("name") == "knn_kernel" for e in events)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spill", [1, 2])
def test_ivf_build_on_cuda_matches_cpu(cuda, dtype, spill):
    """An IVF index built on the card equals one built on the CPU from the same rows and
    seed (k-means sums in float64, so its decisions do not depend on the device): the
    centroids within 1e-5 relative, every id in the same slot, and the same ids at
    nprobe 1, 4 and C, before and after upserts and deletes."""
    from mlvectordb_tpu_torch.ops.kmeans import train_kmeans

    rng = np.random.default_rng(17)
    centers = rng.standard_normal((60, 64)).astype(np.float32) * 4
    x = np.concatenate([c + rng.standard_normal((300, 64)).astype(np.float32) for c in centers])
    x = x[rng.permutation(len(x))]
    queries = x[:64] + 0.1 * rng.standard_normal((64, 64)).astype(np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    qps = {"card": QueryProcessor(EngineConfig(dtype=dtype), device=cuda),
           "cpu": QueryProcessor(EngineConfig(dtype=dtype), device="cpu")}
    for qp in qps.values():
        qp.bulk_load(x, "ns", ids=ids)
        qp.build_ivf("ns", seed=3, spill=spill)
    ivf = {dev: qp.storage.namespace("ns").ivf for dev, qp in qps.items()}
    got, want = ivf["card"].centroids.cpu(), ivf["cpu"].centroids
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert ivf["card"]._id_to_slot == ivf["cpu"]._id_to_slot
    assert ivf["card"]._extra_slots == ivf["cpu"]._extra_slots
    assert torch.equal(ivf["card"].valid3.cpu(), ivf["cpu"].valid3)
    data = torch.from_numpy(x)
    c_cuda, a_cuda = train_kmeans(data.to(cuda), torch.ones(len(x), dtype=torch.bool,
                                                             device=cuda), 100, seed=5)
    c_cpu, a_cpu = train_kmeans(data, torch.ones(len(x), dtype=torch.bool), 100, seed=5)
    assert torch.equal(a_cuda.cpu(), a_cpu)

    def answers(nprobe):
        out = {}
        for dev, qp in qps.items():
            res = qp.find_similar_batch([VectorDTO(q) for q in queries], 10, "ns", "l2",
                                        nprobe=nprobe)
            out[dev] = [[r["id"] for r in rs] for rs in res]
        return out

    for nprobe in (1, 4, ivf["cpu"].C):
        out = answers(nprobe)
        assert out["card"] == out["cpu"], nprobe
    for qp in qps.values():
        qp.upsert_many([VectorDTO(x[i] + 0.5, {"moved": i}, ids[i]) for i in range(50)], "ns")
        qp.bulk_load(queries[:20], "ns", ids=[uuid.UUID(int=10**6 + i) for i in range(20)])
        qp.delete(ids[100:400], "ns")
    assert ivf["card"]._id_to_slot == ivf["cpu"]._id_to_slot
    for nprobe in (1, 4):
        out = answers(nprobe)
        assert out["card"] == out["cpu"], nprobe


# ------------------------------------------------------------------ the distributed engine


def _sharded_answers(devices, cfg, x, ids, q, r, s, metric):
    """A (r, s) distributed engine over ``devices`` holding ``x``: its answers before and
    after deletes and under a filter, and the kernel launches of its first search."""
    from mlvectordb_tpu_torch.parallel import make_distributed_processor

    qp = make_distributed_processor(r, s, cfg, devices=devices)
    qp.bulk_load(x, "ns", ids=ids, metadatas=[{"odd": i % 2} for i in range(len(x))])
    counters = (fused_knn._window_mins_masked, fused_knn_t._window_mins_t,
                fused_knn_t._gather_score)
    before = [fn.launches for fn in counters]
    res = qp.find_similar_batch(q, 10, "ns", metric)
    launched = [fn.launches - b for fn, b in zip(counters, before)]
    # one copy each way; a sweep proof that fails adds the escalation's own copies
    assert qp.transfer_counts["h2d"] == 1
    assert qp.transfer_counts["d2h"] == 1 or cfg.sweep_dtype is not None
    qp.delete(ids[::50], "ns")
    res2 = qp.find_similar_batch(q, 10, "ns", metric)
    res3 = qp.find_similar_batch(q, 10, "ns", metric, filter={"odd": 1})
    return (res, res2, res3), launched


def _same_sharded_answers(got, want):
    for a, b in zip(got, want):
        for ra, rb in zip(a, b):
            assert [r["id"] for r in ra] == [r["id"] for r in rb]
            np.testing.assert_allclose([r["score"] for r in ra], [r["score"] for r in rb],
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sweep", [None, "bfloat16"], ids=["row_major", "bf16_mirror"])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_sharded_search_on_cuda_matches_cpu(cuda, sweep, metric):
    """A (2, 2) distributed engine on [cuda:0] * 4 gives the CPU's answers (before and
    after deletes, filtered), launching one kernel per shard of each replica holding a
    live query: B = 40 in the 64 bucket spans both replicas' halves (32 rows each), so 4
    launches."""
    rng = np.random.default_rng(19)
    x = rng.standard_normal((40000, 96), dtype=np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    q = [VectorDTO(v) for v in rng.standard_normal((40, 96), dtype=np.float32)]
    cfg = EngineConfig(sweep_dtype=sweep)
    want, _ = _sharded_answers([torch.device("cpu")] * 4, cfg, x, ids, q, 2, 2, metric)
    got, launched = _sharded_answers([cuda] * 4, cfg, x, ids, q, 2, 2, metric)
    _same_sharded_answers(got, want)
    assert launched == ([4, 0, 0] if sweep is None else [0, 4, 4])


def test_sharded_search_across_cards():
    """The shards on cuda:0 .. cuda:n-1 (n >= 2 cards): the CPU's answers."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    n = torch.cuda.device_count()
    rng = np.random.default_rng(23)
    x = rng.standard_normal((n * 16384, 128), dtype=np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    q = [VectorDTO(v) for v in rng.standard_normal((16, 128), dtype=np.float32)]
    cfg = EngineConfig(sweep_dtype="bfloat16")
    want, _ = _sharded_answers([torch.device("cpu")] * n, cfg, x, ids, q, 1, n, "l2")
    got, launched = _sharded_answers([torch.device("cuda", i) for i in range(n)], cfg, x,
                                     ids, q, 1, n, "l2")
    _same_sharded_answers(got, want)
    assert launched == [0, n, n]
