"""Phase 1 on the live query columns only (``_window_mins_t(..., n_live=n)``), on the CPU.

The engine pads a batch of B queries with zero rows up to its bucket.  Kernel B1/B3's
wrapper then computes only the first ``n_live`` columns (rounded up to 8) and fills the
rest from one zero-query column, cached per program.  Held here:

  * against the full plain call on the same operands: the padded columns bit-equal (NaN
    where the full call has NaN), the live columns within the certificate's slack
    Dp * 2^-22 * |qh| * maxd per query (a CPU BLAS may block a narrower product in another
    order), the pool's positions equal;
  * rows that make 0 * x differ from 0: a mirror row holding +inf or NaN, an inf scale;
  * the engine with the live count against the JAX engine (interpret mode): the same ids
    and the same certificate tiers at B = 5, 70 and 128, over bf16, int8 and f32 mirrors
    and a bf16 store's same-dtype sweep (the rescan B2 on the live rows too).
"""

import types
import uuid

import numpy as np
import pytest
import torch

from mlvectordb_tpu.config import EngineConfig as JaxConfig
from mlvectordb_tpu.engine.query_processor import QueryProcessor as JaxQueryProcessor
from mlvectordb_tpu.interfaces.vector import VectorDTO as JaxDTO
from mlvectordb_tpu.ops import backend as jax_backend
from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.ops import fused_knn_t as T
from mlvectordb_tpu_torch.ops.distances import MASKED

D = 128
N = 2 * T.SWEEP_TILE
BATCH = 256

# the certificate's bound rows each program folds in (None: the same-dtype plan decides)
PROGRAMS = {"light": ("err1", "sqn_sqrt"), "heavy": ("sweep_err", "err1"),
            "int8_two_pass": ("sweep_err",), "int8_resid": ("sweep_err", "err1"),
            "f32": (), "same_dtype": None}
# (r1, outputs): block mins at r1 = 32, the pool beside the window mins and alone at
# r1 = 16 (m = 8), the [B, P] form at r1 = 32
OUTPUTS = {"block_mins": dict(r1=32, emit_block_mins=True),
           "pool": dict(r1=16, emit_topm=8),
           "pool_only": dict(r1=16, emit_topm=8, skip_wm=True),
           "bp": dict(r1=32, transposed=False)}


def _operands(n_live, metric, program, seed, special=None):
    """Kernel B1/B3's operands as the certified search builds them for ``program``, with
    the queries from ``n_live`` on the folded zero query, ~1% tombstones and a dead half
    tile; ``special`` puts +inf or NaN in one mirror row, or +inf in one scale entry.
    Returns (args, kwargs, slack per query)."""
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32))
    q = torch.zeros((BATCH, D))
    q[:n_live] = torch.from_numpy(rng.standard_normal((n_live, D), dtype=np.float32))
    valid = torch.from_numpy(rng.random(N) > 0.01)
    valid[-T.SWEEP_TILE // 2:] = False
    sq = (data * data).sum(-1)
    if program == "same_dtype":
        mirror = data.to(torch.bfloat16)
        _, wb, _, _ = T._plan(certify=True, light=False, metric=metric,
                              mirror_dtype=torch.bfloat16, rescan_dtype=torch.bfloat16,
                              sweep_err=None, resid=None, rscale=None, err1=None, rscale2=None)
        prep = T._prep_terms(valid, sq, N, None, None, None, cap=N, metric=metric,
                             masked=True, use_resid=False, wb_sources=wb, rows=mirror)
        qh, qres, qres_f32 = T._fold_query(q, metric, False, torch.bfloat16, mixed=False)
        z = None
    else:
        wb = PROGRAMS[program]
        resid = program in ("heavy", "int8_resid")
        int8 = program.startswith("int8")
        if program in ("light", "heavy"):
            z, s, e2, e1 = T.quantize_resid_rows(data)
            mirror, s2 = data.to(torch.bfloat16), None
        else:
            mirror, s, z, s2, e2, e1 = T.quantize_int8_resid_rows(data)
            mirror = data.clone() if program == "f32" else mirror
        prep = T._prep_terms(valid, sq, N, s, e2, e1, cap=N, metric=metric, masked=True,
                             use_resid=resid, wb_sources=wb, rscale2=s2, int8_sweep=int8)
        qh, qres, qres_f32 = T._fold_query(q, metric, program == "light", mirror.dtype)
        z = z if resid else None
    qh_l2 = torch.linalg.vector_norm(q, dim=1) * (2.0 if metric == "l2" else 1.0)
    qe = torch.stack([qh_l2, torch.linalg.vector_norm(qres_f32, dim=1)], 1)[:, :len(wb)]
    scale = prep["scale_row"]
    if special in ("inf_row", "nan_row"):
        mirror[777] = float("inf") if special == "inf_row" else float("nan")
    elif special == "inf_scale":
        scale = scale.clone()
        scale[1234] = float("inf")
    args = (qh.contiguous(), qres, mirror, z, prep["rscale_row"], scale, prep["bias_row"])
    maxd = 1.0 if metric == "cosine" else prep["maxd"]
    slack = D * 2.0 ** -22 * qh_l2 * maxd
    return args, dict(qe=qe.contiguous() if wb else None, eb_rows=prep["eb_rows"]), slack


def _bits_equal(got, want):
    """Equal bit for bit where both are numbers (-0.0 == 0.0), NaN exactly where the
    full call has NaN."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _check(got, want, n_c, slack, axis, name):
    """The padded columns [n_c, B) bit-equal, the live ones within the slack."""
    live, pad = got.narrow(axis, 0, n_c), got.narrow(axis, n_c, got.shape[axis] - n_c)
    _bits_equal(pad, want.narrow(axis, n_c, want.shape[axis] - n_c))
    w = want.narrow(axis, 0, n_c)
    dead = w == MASKED
    assert torch.equal(live[dead], w[dead]), name
    shape = [1] * got.dim()
    shape[axis] = n_c
    err = torch.where(dead, torch.zeros_like(w), (live - w).abs())
    assert bool((err <= slack[:n_c].reshape(shape)).all()), (name, float(err.max()))


@pytest.mark.parametrize("n", [1, 5, 64, 127, 128, 200])
@pytest.mark.parametrize("outputs", list(OUTPUTS))
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("program", list(PROGRAMS))
def test_live_columns_match_full_call(program, metric, outputs, n):
    args, kw, slack = _operands(n, metric, program, seed=n * 7 + len(program))
    opts = OUTPUTS[outputs]
    cache = {}
    got = T._window_mins_t(*args, **kw, **opts, n_live=n, zero_cache=cache)
    want = T._window_mins_t_ref(*args, **kw, **opts)
    n_c = T._live_columns(BATCH, n)
    assert n_c == -(-n // 8) * 8 and len(cache) == 1
    transposed = opts.get("transposed", True)
    m = opts.get("emit_topm", 0)
    for g, w, ax, name in zip(got, want, T._query_axes(transposed), ("wmin", "bm", "pool")):
        assert (g is None) == (w is None), name
        if g is None:
            continue
        assert g.shape == w.shape, name
        if name != "pool":
            _check(g, w, n_c, slack, ax, name)
            continue
        gv, gp = T._decode_topm(g, m, 256)
        wv, wp = T._decode_topm(w, m, 256)
        _bits_equal(g[:, :, n_c:], w[:, :, n_c:])
        assert torch.equal(gp, wp)
        err = (gv[:, :, :n_c] - wv[:, :, :n_c]).abs()
        assert bool((err <= slack[None, None, :n_c]).all()), float(err.max())
    # a second call takes the zero query's outputs from the cache
    again = T._window_mins_t(*args, **kw, **opts, n_live=n, zero_cache=cache)
    for g, a in zip(got, again):
        if g is not None:
            _bits_equal(a, g)


@pytest.mark.parametrize("n", [5, 127])
@pytest.mark.parametrize("program,special", [
    (p, s) for p in ("light", "f32", "same_dtype") for s in ("inf_row", "nan_row", "inf_scale")
] + [("int8_resid", "inf_scale")])   # int8 codes hold no inf or NaN
def test_live_columns_keep_non_finite_rows(program, special, n):
    """0 * inf and 0 * NaN are NaN: the zero query's outputs come from the same
    arithmetic, so the padded columns hold NaN exactly where the full call's do."""
    metric = "cosine"  # every program has a scale row here
    args, kw, slack = _operands(n, metric, program, seed=11 + n, special=special)
    for opts in (OUTPUTS["block_mins"], OUTPUTS["pool"]):
        got = T._window_mins_t(*args, **kw, **opts, n_live=n)
        want = T._window_mins_t_ref(*args, **kw, **opts)
        n_c = T._live_columns(BATCH, n)
        assert bool(torch.isnan(want[0][:, n_c:]).any())
        for g, w, ax in zip(got, want, T._query_axes(True)):
            if w is not None:
                _bits_equal(g.narrow(ax, n_c, BATCH - n_c), w.narrow(ax, n_c, BATCH - n_c))
                assert torch.equal(torch.isnan(g), torch.isnan(w))


@pytest.mark.parametrize("metric", ["l2", "cosine"])
@pytest.mark.parametrize("program", list(PROGRAMS))
def test_phase1_budget_covers_the_plain_versions_error(program, metric):
    """The per-element budget the card tests hold the kernel to (``_phase1_budget``) is
    shaped like the window mins and covers the plain version's own f32 error against the
    same formula in float64; it sits inside the certificate's slack."""
    args, kw, slack = _operands(BATCH, metric, program, seed=5)
    qh, qres, mirror, resid, rscale, scale, bias = args
    r1 = 32
    q64 = qh.double().T
    dots = mirror.double() @ q64
    if qres is not None:
        dots = dots + mirror.double() @ qres.double().T
    if resid is not None:
        dots = dots + (resid.double() @ q64) * rscale.double()[:, None]
    rank = dots * (1.0 if scale is None else scale.double()[:, None]) + bias.double()[:, None]
    for t, eb in enumerate(kw["eb_rows"]):
        rank = rank - kw["qe"][:, t].double()[None, :] * eb.double()[:, None]
    nt = N // T.SWEEP_TILE
    exact = rank.reshape(-1, r1, BATCH).amin(1).reshape(nt, T.WLANE, BATCH).permute(0, 2, 1)
    got = T._window_mins_t_ref(*args, **kw, r1=r1)[0]
    budget = T._phase1_budget(*args, **kw, r1=r1)
    assert budget.shape == got.shape
    live = exact < MASKED / 2
    err = torch.where(live, (got.double() - exact).abs(), torch.zeros_like(exact))
    assert bool((err <= budget.double()).all()), float((err / budget).max())
    assert bool((budget <= slack[None, :, None]).all())


def test_live_columns_without_padding_compute_every_column():
    args, kw, _ = _operands(BATCH, "l2", "light", seed=3)
    assert T._live_columns(BATCH, None) == T._live_columns(BATCH, BATCH) == BATCH
    assert T._live_columns(132, 132) == 132 and T._live_columns(512, 70) == 72
    cache = {}
    got = T._window_mins_t(*args, **kw, r1=32, emit_block_mins=True, n_live=BATCH,
                           zero_cache=cache)
    want = T._window_mins_t_ref(*args, **kw, r1=32, emit_block_mins=True)
    assert cache == {}
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(g, w)


@pytest.mark.parametrize("n_c", [1, 5, 8, 16, 17, 127, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_query_operand_is_the_live_rows(dtype, n_c):
    """Kernel B1/B3's query operand: the first n_c folded query rows as they are (f32 for
    an f32 mirror, split by the kernel; bf16 otherwise), [Bq, Dp] with Bq = n_c rounded up
    to 8 and zero past n_c; a row count already a multiple of 8 is the rows themselves."""
    rng = np.random.default_rng(n_c)
    q = torch.from_numpy(rng.standard_normal((132, 384), dtype=np.float32)).to(dtype)
    q[0, :3] = torch.tensor([2.0 ** -100, -3.0e38, float("nan")])
    got = T._query_rows(q, n_c)
    bq = -(-n_c // 8) * 8
    assert got.dtype == dtype and tuple(got.shape) == (bq, 384) and got.is_contiguous()
    assert torch.equal(got[:n_c].view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       q[:n_c].view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert not bool(got[n_c:].any())
    if bq == n_c:
        assert got.data_ptr() == q.data_ptr()


# ------------------------------------------------------------------ the engine


# the engines' configurations: a mirror over an f32 store, or a bf16 store's own rows
SWEEPS = {"bfloat16": dict(sweep_dtype="bfloat16"), "int8": dict(sweep_dtype="int8"),
          "float32": dict(sweep_dtype="float32"),
          "bf16_store": dict(dtype="bfloat16", sweep_dtype="bfloat16")}


@pytest.fixture(scope="module")
def engines():
    """The same 12,000-row namespace in the JAX engine and in the port's, for a bf16, an
    int8 and an f32 mirror over an f32 store, and a bf16 store's same-dtype sweep.  The
    JAX engine picks its certified sweep only on a TPU; here it is told it runs on one,
    and its Pallas kernels run in interpret mode."""
    rng = np.random.default_rng(2026)
    x = rng.standard_normal((12_000, D), dtype=np.float32)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, len(x))]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backend, "jax", types.SimpleNamespace(default_backend=lambda: "tpu"))
        for sweep in SWEEPS:
            kw = dict(SWEEPS[sweep])
            jqp = JaxQueryProcessor(config=JaxConfig(**kw))
            tqp = QueryProcessor(EngineConfig(**kw), device="cpu")
            jqp.bulk_load(x, "ns", ids=ids)
            tqp.bulk_load(x, "ns", ids=ids)
            out[sweep] = (jqp, tqp)
        yield out


@pytest.mark.parametrize("b", [5, 70, 128])
@pytest.mark.parametrize("sweep", list(SWEEPS))
def test_engine_with_live_count_matches_jax(engines, sweep, b):
    jqp, tqp = engines[sweep]
    queries = np.random.default_rng(b).standard_normal((b, D), dtype=np.float32)
    jt0, tt0 = jqp.cert_tier_counts("ns"), tqp.cert_tier_counts("ns")
    prep = tqp.storage.namespace("ns").device_state().prep_cache
    for p in prep.values():                      # earlier batches' zero-query outputs
        p.pop("zero_query", None)
    jr = jqp.find_similar_batch([JaxDTO(v) for v in queries], 10, "ns", "l2")
    tr = tqp.find_similar_batch([VectorDTO(v) for v in queries], 10, "ns", "l2")
    for a, c in zip(jr, tr):
        assert len(c) == 10 and {r["id"] for r in a} == {r["id"] for r in c}
        np.testing.assert_allclose(sorted(r["score"] for r in c),
                                   sorted(r["score"] for r in a), rtol=1e-4, atol=1e-4)

    def added(now, before):
        return {t: v - before.get(t, 0) for t, v in now.items() if v != before.get(t, 0)}

    assert added(tqp.cert_tier_counts("ns"), tt0) == added(jqp.cert_tier_counts("ns"), jt0)
    # a padded bucket keeps its zero query's outputs in the snapshot's prep
    padded = tqp.config.bucket_batch(b) > T._live_columns(tqp.config.bucket_batch(b), b)
    assert any(p.get("zero_query") for p in prep.values()) == padded
