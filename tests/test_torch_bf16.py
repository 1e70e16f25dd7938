"""bf16 storage of the port (``EngineConfig(dtype="bfloat16")``): the row-major path on
bf16 rows (kernels B4/B5), the same-dtype certified sweep (a bf16 mirror of bf16 rows:
kernel B1 in one pass, kernel B2 rescanning the bf16 rows), kernel B1's non-transposed
``[B, P]`` output, the store's upkeep and the engine, against the JAX package on the CPU.

The port's kernel wrappers run their plain torch versions on CPU tensors; the JAX side
runs its Pallas kernels in interpret mode.  Inputs are made with numpy from a seed.  bf16
rows are the f32 inputs rounded to nearest even on both sides; every product of a bf16
row with a bf16-rounded query is exact in f32.

Tolerances:
  * B4/B5 window mins: fully masked windows equal (exactly 3e38); live windows within
    1e-5 * |x| + 1e-3, the same f32 sums in another order (tests/test_torch_fused_knn.py);
  * B1 window mins (both layouts): live windows within the certificate's accumulation
    slack Dp * 2^-22 * |qh| * maxd per query (tests/test_torch_sweep.py);
  * searches: the certificate tier equal to the JAX package's; id sets equal on gaussian
    data (and to a float64 brute force over the bf16 rows with the f32 query); distances
    within 1e-4 relative + 1e-4 (both rescan the same bf16 rows in f32 with the same
    formulas);
  * store arrays: rows bit-equal; the port's squared norms are the stored rows' (ROADMAP
    C17), so its twin in the JAX package is a JAX store written bf16(x) in place of x:
    within sqrt(Dp) ulps of the twin's (another summation order) before a compaction,
    and equal after it (both sum the stored rows in float64 and round once); a JAX
    store written x holds the written rows' norms until then.
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
from mlvectordb_tpu.ops import pallas_knn as JR
from mlvectordb_tpu.ops import pallas_knn_t as J
from mlvectordb_tpu.ops import topk as jtopk
from mlvectordb_tpu.store.namespace import NamespaceStore as JaxNamespaceStore
from mlvectordb_tpu.store.vector import Vector as JaxVector
from mlvectordb_tpu_torch import EngineConfig, NamespaceStore, QueryProcessor, VectorDTO, convert
from mlvectordb_tpu_torch.ops import fused_knn as TR
from mlvectordb_tpu_torch.ops import fused_knn_t as T
from mlvectordb_tpu_torch.ops.distances import MASKED
from mlvectordb_tpu_torch.ops.topk import exact_knn
from mlvectordb_tpu_torch.store.vector import Vector

from .test_torch_sweep import _gaussian, _jax_rows, _t

D = 128
TILE = J.SWEEP_TILE
METRICS = ["l2", "ip", "cosine"]
ULP = np.sqrt(D) * 2.0 ** -23


def _bf16(x):
    """f32 values of ``x`` rounded to bf16 (nearest even), as numpy f32."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).float().numpy()


def _bf16_oracle(q, db, k, metric, valid=None):
    """Ids of the k nearest bf16-rounded rows to the f32 queries (float64 brute force)."""
    x = _bf16(db).astype(np.float64)
    q64 = q.astype(np.float64)
    dots = q64 @ x.T
    if metric == "l2":
        d = (q64 * q64).sum(-1)[:, None] + (x * x).sum(-1)[None, :] - 2 * dots
    elif metric == "ip":
        d = 1.0 - dots
    else:
        d = 1.0 - dots / np.sqrt((q64 * q64).sum(-1)[:, None] * (x * x).sum(-1)[None, :])
    if valid is not None:
        d[:, ~valid] = np.inf
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def _assert_window_mins_close(got, want):
    dead = want == MASKED
    np.testing.assert_array_equal(got[dead], want[dead])
    err = np.abs(got[~dead] - want[~dead])
    assert (err <= 1e-5 * np.abs(want[~dead]) + 1e-3).all(), float(err.max())


def _assert_same(j, t, oracle_ids=None, tier=True):
    """Tiers equal (when reported), id sets equal (and to the oracle's), distances close."""
    if tier:
        assert t[2] == j[2]
    for b in range(t[1].shape[0]):
        assert set(t[1][b].tolist()) == set(np.asarray(j[1])[b].tolist()), b
        if oracle_ids is not None:
            assert set(t[1][b].tolist()) == set(oracle_ids[b].tolist()), b
    np.testing.assert_allclose(np.sort(t[0], 1), np.sort(np.asarray(j[0]), 1), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------------------------ B4 / B5 on bf16 rows


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("r1", [8, 32])
@pytest.mark.parametrize("variant", ["fast", "masked"])
def test_window_mins_bf16_rows_plain_matches_pallas(variant, r1, metric):
    n, b = 2 * TR.DB_TILE, 8
    rng, db, q = _gaussian(300 + r1 + len(metric), n, b)
    qn = (q * q).sum(-1)[None, :]                 # the f32 query's norms
    qt16 = _bf16(q.T)                             # the query rounded to the rows' type
    jq = (jnp.asarray(db, jnp.bfloat16), jnp.asarray(q.T, jnp.bfloat16), jnp.asarray(qn))
    tq = (_t(db).to(torch.bfloat16), _t(qt16), _t(qn))
    kw = dict(metric=metric, db_tile=TR.DB_TILE, r1=r1)
    if variant == "fast":
        hw = n - TR.DB_TILE - 1000
        want = JR._window_mins_fast(*jq, jnp.asarray([[hw]], jnp.int32), q_tile=b, **kw)
        got = TR._window_mins_fast(*tq, hw, **kw)
    else:
        valid = rng.random(n) > 0.01
        valid[-TR.DB_TILE:] = False
        maskadd = np.where(valid, 0.0, MASKED).astype(np.float32)
        bias = ((db * db).sum(-1) + maskadd if metric == "l2" else maskadd)
        bias = bias.astype(np.float32)[:, None]
        want = JR._window_mins_masked(*jq, jnp.asarray(bias), q_tile=b, **kw)
        got = TR._window_mins_masked(*tq, _t(bias), **kw)
    assert TR._window_mins_fast.launches == TR._window_mins_masked.launches == 0
    want = np.asarray(want)
    assert (want == MASKED).any()
    _assert_window_mins_close(got.numpy(), want)


def test_bf16_rows_operand_checks():
    data = torch.zeros((8192, D), dtype=torch.bfloat16)
    qt, qn = torch.zeros((D, 8)), torch.zeros((1, 8))
    assert TR._check_operands(data, qt, qn, None, metric="l2", db_tile=4096, r1=8) == (
        8192, D, 8)
    for bad in ((data, qt.to(torch.bfloat16), qn),            # the query travels as f32
                (data.to(torch.float16), qt, qn)):            # rows: f32 or bf16 only
        with pytest.raises(ValueError):
            TR._check_operands(*bad, None, metric="l2", db_tile=4096, r1=8)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("live", [True, False])
def test_exact_knn_fused_bf16_matches_pallas(live, metric):
    n, b = 4 * TR.DB_TILE, 16
    rng, db, q = _gaussian(310 + len(metric), n, b)
    valid = np.ones(n, bool)
    if not live:
        valid = rng.random(n) > 0.05
        q = db[:b] + np.float32(1e-3)             # the nearest rows are the queried ones...
        valid[:b:2] = False                       # ...and every other one of them is dead
    sq = (db * db).sum(-1).astype(np.float32)     # the written f32 rows' norms
    lp = n if live else None
    jd, ji = JR.exact_knn_pallas(jnp.asarray(q), jnp.asarray(db, jnp.bfloat16),
                                 jnp.asarray(valid), jnp.asarray(sq), k=10, metric=metric,
                                 live_prefix=lp)
    td, ti = TR.exact_knn_fused(_t(q), _t(db).to(torch.bfloat16), _t(valid), _t(sq), k=10,
                                metric=metric, live_prefix=lp)
    assert ti.dtype == torch.int32 and valid[ti.numpy()].all()
    _assert_same((jd, ji), (td.numpy(), ti.numpy()), _bf16_oracle(q, db, 10, metric, valid),
                 tier=False)


# ------------------------------------------------------------------ the exact scan (tier 2)


@pytest.mark.parametrize("metric", METRICS)
def test_exact_scan_bf16_rows_matches_jax(metric):
    """ops/distances rounds the query to the rows' type, as the JAX package does: the
    scan of a bf16 store (tier 2 and small namespaces) ranks bf16(q) . bf16(row).  The
    norms beside it: JAX adds the ones it is handed (here the written f32 rows', as a JAX
    store holds them until its first compaction), and returns the top 10 of that f32
    formula; the port's float64 settle (ROADMAP C18) scores the stored rows themselves
    (the norms the port's store holds, C17) and returns, in order, the float64 top 10 of
    |q|^2 - |bf16(q)|^2 + |bf16(row) - bf16(q)|^2 (ip: 1 - bf16(q) . bf16(row); cosine:
    1 - bf16(q) . bf16(row) / (|q| |bf16(row)|)), each distance fl32 of that value."""
    rng, db, q = _gaussian(320 + len(metric), 3000, 8)
    valid = rng.random(3000) > 0.1
    sq = (db * db).sum(-1).astype(np.float32)
    jd, ji = jtopk.exact_knn(jnp.asarray(q), jnp.asarray(db, jnp.bfloat16), jnp.asarray(valid),
                             jnp.asarray(sq), k=10, metric=metric, db_tile=1024)
    td, ti = exact_knn(_t(q), _t(db).to(torch.bfloat16), _t(valid), _t(sq), k=10,
                       metric=metric, db_tile=1024)
    jd, ji, td, ti = np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()
    rows = _bf16(db).astype(np.float64)
    qr, q64 = _bf16(q).astype(np.float64), q.astype(np.float64)
    qq, dots = (q64 * q64).sum(-1)[:, None], qr @ rows.T
    if metric == "l2":
        port = qq - (qr * qr).sum(-1)[:, None] + np.stack([((rows - v) ** 2).sum(-1) for v in qr])
        jax_ = qq + sq[None, :].astype(np.float64) - 2 * dots
    elif metric == "ip":
        port = jax_ = 1 - dots
    else:
        port = 1 - dots / np.sqrt(qq * (rows * rows).sum(-1)[None, :])
        jax_ = 1 - dots / np.sqrt(qq * sq[None, :].astype(np.float64))
    port[:, ~valid] = jax_[:, ~valid] = np.inf
    want = np.argsort(port, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(ti, want)                      # the port: float64
    np.testing.assert_array_equal(td, np.take_along_axis(port, want, 1).astype(np.float32))
    for b in range(len(q)):                                      # JAX: its formula, in f32
        assert set(ji[b].tolist()) == set(np.argsort(jax_[b], kind="stable")[:10].tolist()), b
    np.testing.assert_allclose(jd, np.take_along_axis(jax_, ji, 1), rtol=1e-5, atol=1e-4)
    assert (np.diff(jd, axis=1) >= 0).all()


# ------------------------------------------------------------------ the same-dtype sweep


def _same_dtype(db, q, valid, *, metric, k, live_prefix=None):
    """The same-dtype certified search through the JAX entry (interpret mode: the bf16
    rows in the sweep layout, the bf16 rows as the rescan) and the port's (the bf16 rows
    as mirror and rescan), with the port's kernel calls: ((dist, idx, tier) of JAX, of
    the port, [(qres, resid) per kernel call])."""
    n = db.shape[0]
    sq = (db * db).sum(-1).astype(np.float32)     # the written f32 rows' norms
    lp = n if live_prefix is None and valid.all() else live_prefix
    rows_j = jnp.asarray(db, jnp.bfloat16)
    jd, ji, jt = J.exact_knn_pallas_t(
        jnp.asarray(q), J.to_sweep_layout(rows_j), rows_j, jnp.asarray(valid),
        jnp.asarray(sq), k=k, metric=metric, live_prefix=lp, report_tier=True)
    rows_t = _t(db).to(torch.bfloat16)
    calls = []
    real = T._window_mins_t

    def spy(qh, qres, mirror, resid, *a, **kw):
        calls.append((qres, resid))
        return real(qh, qres, mirror, resid, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "_window_mins_t", spy)
        td, ti, tt = T.exact_knn_t(_t(q), rows_t, rows_t, _t(valid), _t(sq), k=k,
                                   metric=metric, live_prefix=lp, report_tier=True)
    return (np.asarray(jd), np.asarray(ji), int(jt)), (td.numpy(), ti.numpy(), tt), calls


@pytest.mark.parametrize("metric", METRICS)
def test_same_dtype_sweep_matches_jax(metric):
    _, db, q = _gaussian(330 + len(metric), 4 * TILE, 8)
    j, t, calls = _same_dtype(db, q, np.ones(4 * TILE, bool), metric=metric, k=10)
    assert t[2] == j[2] == 0
    _assert_same(j, t, _bf16_oracle(q, db, 10, metric))
    # one pass: no query compensation, no residual stream (JAX's mixed=False program)
    assert calls == [(None, None)] and T._window_mins_t.launches_heavy == 0


@pytest.mark.parametrize("metric", METRICS)
def test_same_dtype_sweep_tombstoned_matches_jax(metric):
    rng, db, q = _gaussian(340 + len(metric), 4 * TILE, 16)
    valid = rng.random(4 * TILE) > 0.05
    q = db[:16] + np.float32(1e-3)
    valid[:16:2] = False
    j, t, calls = _same_dtype(db, q, valid, metric=metric, k=10)
    assert t[2] == j[2]
    _assert_same(j, t, _bf16_oracle(q, db, 10, metric, valid))
    assert valid[t[1]].all() and calls == [(None, None)]


@pytest.mark.parametrize("metric", METRICS)
def test_same_dtype_sweep_k100_matches_jax(metric):
    """32 tiles, k=100: the k bucket 128 program with the per-tile top-m pool."""
    _, db, q = _gaussian(350 + len(metric), 32 * TILE, 8)
    launches = T._window_mins_t.launches_topm
    j, t, calls = _same_dtype(db, q, np.ones(32 * TILE, bool), metric=metric, k=100)
    assert t[2] == j[2] == 0
    _assert_same(j, t, _bf16_oracle(q, db, 100, metric))
    assert calls == [(None, None)]
    assert T._window_mins_t.launches_topm == launches    # CPU tensors: the plain version


def test_same_dtype_plan_fold_and_prep():
    """The same-dtype plan (pallas_knn_t.py:928-936): l2/ip fold one bound row sqrt(sqn)
    scaled by |qres|; cosine carries |qres| as a scalar term; no compensation pass.  The
    port adds the gap between the norms the rank uses and the stored rows' own (ROADMAP
    C2): l2 a second bound row |sqn - |bf16 row|^2| at scale 1, cosine one row
    ||x| - |bf16 row|| / |x| at scale |q|; ip ranks no norm and keeps JAX's plan."""
    n = 2 * TILE
    _, db, q = _gaussian(360, n, 4)
    rows = _t(db).to(torch.bfloat16)
    sq = _t((db * db).sum(-1))
    for metric in METRICS:
        plan = T._plan(certify=True, light=False, metric=metric, mirror_dtype=torch.bfloat16,
                       rescan_dtype=torch.bfloat16, sweep_err=None, resid=None, rscale=None,
                       err1=None, rscale2=None)
        want = J._cert_plan(certify=True, light=False, mixed=False, lossy_sweep=True,
                            int8_sweep=False, use_resid=False, has_sweep_err=False,
                            has_err1=False, metric=metric)
        gap = {"l2": (("sqn_sqrt", "norm_gap"), ("qres", "one"), ()),
               "ip": want, "cosine": (("norm_gap",), ("qh",), ("qres",))}[metric]
        assert plan == (False, *gap)
        assert want == (((), (), ("qres",)) if metric == "cosine" else (
            ("sqn_sqrt",), ("qres",), ()))
        qh, qres, qres_f32 = T._fold_query(_t(q), metric, False, torch.bfloat16, mixed=False)
        assert qh.dtype == torch.bfloat16 and qres is None and bool((qres_f32 != 0).any())
        # the mixed program's compensation operand is still there for a bf16 mirror of f32
        assert T._fold_query(_t(q), metric, False, torch.bfloat16)[1] is not None
    prep = T.search_prep(rows, torch.ones(n, dtype=torch.bool), sq, metric="l2",
                         live_prefix=n, rescan_dtype=torch.bfloat16)
    assert prep["rscale_row"] is None and len(prep["eb_rows"]) == 2
    assert torch.equal(prep["eb_rows"][0], torch.sqrt(sq))
    own = (rows.float() * rows.float()).sum(-1)
    assert torch.equal(prep["eb_rows"][1], (sq - own).abs())
    mixed = T.search_prep(rows, torch.ones(n, dtype=torch.bool), sq, metric="l2",
                          live_prefix=n)            # f32 rows by default: the light-less plan
    assert mixed["eb_rows"] == ()


# ------------------------------------------------------------------ B1's [B, P] output


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("r1", [32, 16, 4])
def test_bp_output_plain_matches_pallas(r1, metric):
    """The non-transposed output (pallas_knn_t.py:453-457) of the same-dtype program:
    JAX's [B, nt*g*128] against the port's plain version, and the port's [B, P] equal to
    its own tile-major output at the same positions."""
    n, b = 2 * TILE, 8
    rng, db, q = _gaussian(370 + r1 + len(metric), n, b)
    valid = rng.random(n) > 0.01
    valid[-TILE // 2:] = False
    sq = (db * db).sum(-1).astype(np.float32)
    wb = () if metric == "cosine" else ("sqn_sqrt",)
    prep = T._prep_terms(_t(valid), _t(sq), n, None, None, None, cap=n, metric=metric,
                         masked=True, use_resid=False, wb_sources=wb)
    qh, _, qres_f32 = T._fold_query(_t(q), metric, False, torch.bfloat16, mixed=False)
    qe = torch.linalg.vector_norm(qres_f32, dim=1)[:, None].contiguous() if wb else None
    scale = prep["scale_row"]
    ebs = [e.numpy() for e in prep["eb_rows"]]
    want = J._window_mins(
        jnp.asarray(qh.float().numpy(), jnp.bfloat16), None,
        J.to_sweep_layout(jnp.asarray(db, jnp.bfloat16)), None, None,
        _jax_rows(None if scale is None else scale.numpy()),
        _jax_rows(prep["bias_row"].numpy()), q_tile=b, g=32 // r1, transposed=False,
        qe=None if qe is None else jnp.pad(jnp.asarray(qe.numpy()), ((0, 0), (0, 127))),
        eb_rows=tuple(_jax_rows(e) for e in ebs))
    args = (qh, None, _t(db).to(torch.bfloat16), None, None, scale, prep["bias_row"])
    kw = dict(r1=r1, qe=qe, eb_rows=prep["eb_rows"])
    before = (T._window_mins_t.launches, T._window_mins_t.launches_bp)
    got, bm, pool = T._window_mins_t(*args, transposed=False, **kw)
    assert (T._window_mins_t.launches, T._window_mins_t.launches_bp) == before
    assert bm is None and pool is None
    want = np.asarray(want)
    assert got.shape == want.shape == (b, n // r1)
    maxd = 1.0 if metric == "cosine" else float(np.sqrt(sq[valid].max()))
    q_fold = (-2.0 if metric == "l2" else -1.0) * q
    slack = (D * 2.0 ** -22 * np.linalg.norm(q_fold, axis=1) * maxd)[:, None]
    dead = want == MASKED
    assert dead.any() and (~dead).any()
    np.testing.assert_array_equal(got.numpy()[dead], want[dead])
    err = np.where(dead, 0.0, np.abs(got.numpy() - want))
    assert (err <= slack).all(), float((err / slack).max())
    tile_major = T._window_mins_t(*args, **kw)[0]
    assert torch.equal(got.reshape(b, -1, (32 // r1) * 128).permute(1, 0, 2), tile_major)
    # the block mins and the pool need the tile-major output, as in the JAX package
    with pytest.raises(ValueError):
        T._window_mins_t(*args, transposed=False, emit_block_mins=True, **{**kw, "r1": 32})
    with pytest.raises(ValueError):
        T._window_mins_t(*args, transposed=False, emit_topm=8, **{**kw, "r1": 16})


@pytest.mark.parametrize("r1", [32, 4])
def test_out_layout_probe_plain_forms_agree(r1):
    """Probe B6 (probes/out_layout) on the CPU, at its own shape (r1 = 32) and the k=1000
    program's (r1 = 4): the two layouts' plain versions hold the same window mins; its
    GB/s count is the TPU probe's."""
    from mlvectordb_tpu_torch.probes import out_layout

    _, db, q = _gaussian(380 + r1, 2 * TILE, 8)
    ops = out_layout.operands(_t(db), _t(q))
    assert ops[0].dtype == ops[1].dtype == torch.bfloat16 and not bool(ops[2].any())
    a, c = out_layout.out_2d(*ops, r1), out_layout.out_3d(*ops, r1)
    g = 32 // r1
    assert a.shape == (8, 2 * g * 128) and c.shape == (2, 8, g * 128)
    assert torch.equal(out_layout.as_tile_major(a, r1), c)
    assert torch.equal(a, out_layout.out_2d_ref(*ops, r1))
    assert torch.equal(c, out_layout.out_3d_ref(*ops, r1))
    assert out_layout.gbs(1 << 23, 128, 128, 1.0) == pytest.approx(
        ((1 << 23) * 128 * 2 + 128 * 2048 * 128 * 4) / 1e6)


# ------------------------------------------------------------------ the store


def _store_config(cls, sweep, **kw):
    return cls(dtype="bfloat16", sweep_dtype=sweep, initial_capacity=4096,
               capacity_multiple=4096, **kw)


def _assert_store_matches_jax(jns, tns, *, rebuilt):
    """The port's bf16 store arrays against the JAX twin's, a JAX store written the
    bf16-rounded values (see the module docstring), and against the port's own
    compaction of its rows: norms within sqrt(Dp) ulps, equal once compacted."""
    st = tns.device_state()
    rebuild = T.row_sq_norms(st.data)
    if rebuilt:
        assert torch.equal(st.sq_norms, rebuild)
    else:
        assert bool((torch.abs(st.sq_norms - rebuild) <= ULP * rebuild + 1e-30).all())
    assert st.data.dtype == torch.bfloat16
    assert np.array_equal(st.data.view(torch.int16).numpy(),
                          np.asarray(jns._data).view(np.int16))
    assert np.array_equal(st.valid.numpy(), np.asarray(jns._valid))
    got, want = st.sq_norms.numpy(), np.asarray(jns._sq_norms)
    if rebuilt:
        assert np.array_equal(got, want)
    else:
        assert (np.abs(got - want) <= ULP * want + 1e-30).all()
    assert st.sweep_err is None and st.sweep_resid is None and st.sweep_rscale is None
    same = tns.config.sweep_dtype == "bfloat16"
    assert (st.mirror is st.data) == same and (st.mirror is None) == (not same)
    if same:
        # the JAX store's transposed copy holds the port's rows
        carried = convert.sweep_arrays_from_jax(np.asarray(jns._data_t), device="cpu")
        assert torch.equal(carried["mirror"].view(torch.int16), st.data.view(torch.int16))
        # the port keeps the rows once; the JAX store counts its copy as well
        assert tns.nbytes == jns.nbytes - tns.capacity * tns.dpad * 2
    else:
        assert tns.nbytes == jns.nbytes
    assert tns.nbytes == sum(t.numel() * t.element_size()
                             for t in (st.data, st.valid, st.sq_norms))


def _assert_jax_written_norms(jns, tns, changed):
    """ROADMAP C17: a JAX store written x holds the port's rows and liveness, but its
    norms are the written rows' until a compaction: off the port's by more than
    sqrt(Dp) ulps on nearly every live row that rounding changed (``changed``; the
    rounding errors of a row can cancel in its norm), within them elsewhere (another
    summation order)."""
    st = tns.device_state()
    assert np.array_equal(st.data.view(torch.int16).numpy(),
                          np.asarray(jns._data).view(np.int16))
    assert np.array_equal(st.valid.numpy(), np.asarray(jns._valid))
    got, want = st.sq_norms.numpy(), np.asarray(jns._sq_norms)
    near = np.abs(got - want) <= ULP * want + 1e-30
    live = st.valid.numpy()
    assert (near & changed & live).sum() <= 0.05 * (changed & live).sum()
    assert near[~changed & live].all()


@pytest.mark.parametrize("sweep", [None, "bfloat16"])
def test_bf16_store_upkeep_matches_jax(sweep):
    """Writes, overwrites, growth, deletes and a compaction on a port store, a JAX store
    written the same values (x) and its twin written bf16(x): the port's arrays are the
    twin's at every step and its own compaction's; the JAX store written x holds the
    written rows' norms until its compaction, which gives it the port's (C17)."""
    rng = np.random.default_rng(390 + (sweep is None))
    jns = JaxNamespaceStore("w", _store_config(JaxConfig, sweep, use_pallas=False))
    twin = JaxNamespaceStore("w", _store_config(JaxConfig, sweep, use_pallas=False))
    tns = NamespaceStore("w", _store_config(EngineConfig, sweep), device="cpu")
    x = rng.standard_normal((3000, D), dtype=np.float32) * 2.0
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    for ns, v in ((jns, x), (twin, _bf16(x)), (tns, x)):
        ns.bulk_upsert(v, ids)
    _assert_store_matches_jax(twin, tns, rebuilt=False)      # bulk load
    changed = np.zeros(4096, bool)
    changed[:3000] = (x != _bf16(x)).any(1)
    _assert_jax_written_norms(jns, tns, changed)
    more = rng.standard_normal((3000, D), dtype=np.float32)
    more_ids = [uuid.UUID(int=i + 10_000) for i in range(len(more))]
    over = rng.standard_normal((4, D), dtype=np.float32)
    for ns, vec, r in ((jns, JaxVector, lambda v: v), (twin, JaxVector, _bf16),
                       (tns, Vector, lambda v: v)):
        ns.bulk_upsert(r(more), more_ids)                    # growth past the first tile
        ns.upsert([vec(r(v), {}, id=ids[i]) for i, v in zip((5, 17, 2999, 0), over)])
    assert tns.capacity == jns.capacity == twin.capacity == 8192
    _assert_store_matches_jax(twin, tns, rebuilt=False)
    changed = np.concatenate([changed, np.zeros(4096, bool)])
    changed[3000:6000] = (more != _bf16(more)).any(1)
    changed[[5, 17, 2999, 0]] = (over != _bf16(over)).any(1)
    _assert_jax_written_norms(jns, tns, changed)
    # the norms are the bf16 rows' f32 sums at write time, not the written f32 rows'
    st = tns.device_state()
    bf = st.data[: 6000].float()
    assert torch.equal(st.sq_norms[: 6000], (bf * bf).sum(-1))
    assert not np.array_equal(np.asarray(jns._sq_norms)[5], float((bf[5] * bf[5]).sum()))
    for ns in (jns, twin, tns):
        ns.delete(ids[:500])                                 # tombstones, below the ratio
    _assert_store_matches_jax(twin, tns, rebuilt=False)
    _assert_jax_written_norms(jns, tns, changed)
    for ns in (jns, twin, tns):
        ns.delete(ids[500:2500])                             # above it: compaction
    assert tns._tombstones == 0 and tns.capacity == jns.capacity == 4096
    _assert_store_matches_jax(twin, tns, rebuilt=True)
    _assert_store_matches_jax(jns, tns, rebuilt=True)        # a compaction: the same arrays
    # hydration returns the written f32 values; a snapshot the stored rows as f32
    live = tns.device_state().high_water
    assert np.array_equal(tns.get(ids[2500]).values, x[2500])
    assert np.array_equal(tns.get(ids[2999]).values, over[2])
    snap, jsnap = tns.snapshot_arrays(), jns.snapshot_arrays()
    assert snap["ids"] == jsnap["ids"] and len(snap["ids"]) == live
    assert snap["values"].dtype == np.float32
    np.testing.assert_array_equal(snap["values"], jsnap["values"])
    np.testing.assert_array_equal(snap["values"], _bf16(np.stack(
        [tns.get(uuid.UUID(i)).values for i in snap["ids"]])))


def test_f32_compaction_norms_match_jax():
    """Compaction recomputes the squared norms from the stored rows as the JAX package
    does (a float64 sum rounded once), where the port carried the old f32 sums over."""
    rng = np.random.default_rng(395)
    cfg = dict(initial_capacity=4096, capacity_multiple=4096)
    jns = JaxNamespaceStore("f", JaxConfig(use_pallas=False, **cfg))
    tns = NamespaceStore("f", EngineConfig(**cfg), device="cpu")
    x = rng.standard_normal((6000, D), dtype=np.float32) * 3.0
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    for ns in (jns, tns):
        ns.bulk_upsert(x, ids)
        ns.delete(ids[:2000])                                # compaction
    assert tns.capacity == jns.capacity == 4096 and tns._tombstones == 0
    np.testing.assert_array_equal(tns.device_state().sq_norms.numpy(),
                                  np.asarray(jns._sq_norms))
    f64 = (x[2000:].astype(np.float64) ** 2).sum(-1).astype(np.float32)
    np.testing.assert_array_equal(tns.device_state().sq_norms.numpy()[:4000], f64)


def test_carry_over_from_jax_bf16_store():
    """A JAX bf16 namespace's snapshot (f32 values of the bf16 rows) rebuilds the same
    rows in the port, and the converted store searches as the JAX store does."""
    rng = np.random.default_rng(397)
    x = rng.standard_normal((9000, D), dtype=np.float32)
    jns = JaxNamespaceStore("w", JaxConfig(dtype="bfloat16", sweep_dtype="bfloat16"))
    jns.bulk_upsert(x, [uuid.UUID(int=i + 1) for i in range(len(x))])
    cfg = EngineConfig(dtype="bfloat16", sweep_dtype="bfloat16")
    tns = convert.store_from_jax_snapshot(jns.snapshot_arrays(), cfg, "cpu")
    assert tns.capacity == jns.capacity == 16384
    ts = tns.device_state()
    rows_t = convert.rows_from_sweep_layout(np.asarray(jns._data_t).view(np.int16))
    assert np.array_equal(ts.data.view(torch.int16).numpy(), rows_t)
    assert ts.mirror is ts.data
    q = rng.standard_normal((8, D), dtype=np.float32)
    st = jns.device_state()
    jd, ji, jt = J.exact_knn_pallas_t(jnp.asarray(q), st.data_t, st.data, st.valid,
                                      st.sq_norms, k=10, metric="l2",
                                      live_prefix=st.high_water, report_tier=True)
    td, ti, tt = T.exact_knn_t(_t(q), ts.mirror, ts.data, ts.valid, ts.sq_norms, k=10,
                               metric="l2", live_prefix=ts.high_water, report_tier=True)
    assert tt == int(jt) == 0
    _assert_same((jd, ji, int(jt)), (td.numpy(), ti.numpy(), tt))


# ------------------------------------------------------------------ the engine


@pytest.fixture(scope="module", params=["row_major", "same_dtype"])
def engines(request):
    """A bf16 namespace of 20,000 gaussian rows in the JAX engine and in the port's (on
    the CPU), row-major or with the same-dtype mirror.  The JAX engine takes its fused
    backend only on a TPU; here it is told it runs on one, and its Pallas kernels still
    run in interpret mode."""
    rng = np.random.default_rng(401)
    x = rng.standard_normal((20_000, D), dtype=np.float32)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, len(x))]
    cfg = dict(dtype="bfloat16",
               sweep_dtype="bfloat16" if request.param == "same_dtype" else None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backend, "jax", types.SimpleNamespace(default_backend=lambda: "tpu"))
        jqp = JaxQueryProcessor(config=JaxConfig(**cfg))
        tqp = QueryProcessor(EngineConfig(**cfg), device="cpu")
        for qp in (jqp, tqp):
            qp.bulk_load(x, "ns", ids=ids)
        yield request.param, rng, x, ids, jqp, tqp


def _search_both(jqp, tqp, queries, k, metric):
    jr = jqp.find_similar_batch([JaxDTO(v) for v in queries], k, "ns", metric)
    tr = tqp.find_similar_batch([VectorDTO(v) for v in queries], k, "ns", metric)
    for a, b in zip(jr, tr):
        assert [r["id"] for r in a] == [r["id"] for r in b]
        np.testing.assert_allclose([r["score"] for r in b], [r["score"] for r in a],
                                   rtol=1e-4, atol=1e-4)
        for ra, rb in zip(a, b):
            np.testing.assert_array_equal(ra["values"], rb["values"])   # the f32 inputs
    return tr


def test_engine_matches_jax_before_and_after_deletes(engines):
    kind, rng, x, ids, jqp, tqp = engines
    st = tqp.storage.namespace("ns").device_state()
    assert st.data.dtype == torch.bfloat16
    assert (st.mirror is st.data) == (kind == "same_dtype")
    queries = rng.standard_normal((16, D), dtype=np.float32)
    calls = []
    real = T._window_mins_t

    def spy(qh, qres, mirror, resid, *a, **kw):
        calls.append((qres is None, resid is None, mirror is st.data))
        return real(qh, qres, mirror, resid, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "_window_mins_t", spy)
        for metric in METRICS:
            before = dict(tqp.transfer_counts)
            tr = _search_both(jqp, tqp, queries, 10, metric)
            assert (tqp.transfer_counts["h2d"] - before["h2d"],
                    tqp.transfer_counts["d2h"] - before["d2h"]) == (1, 1)
            assert all(len(r) == 10 for r in tr)
        gone = [ids[i] for i in rng.choice(len(ids), 300, replace=False)]
        assert sorted(map(str, jqp.delete(gone, "ns"))) == sorted(
            map(str, tqp.delete(gone, "ns")))
        for metric in METRICS:
            tr = _search_both(jqp, tqp, queries, 10, metric)
            assert not {r["id"] for rs in tr for r in rs} & set(gone)
    if kind == "same_dtype":
        # one pass over the rows themselves at every search, unprefixed tier 0, no flip
        assert calls == [(True, True, True)] * 6
        assert tqp.cert_tier_counts("ns") == jqp.cert_tier_counts("ns") == {"fast": 6}
        assert tqp._cert_mode == {}
    else:
        # ROADMAP C20: the row-major path proves each batch (tier 0 here) and records
        # it; JAX's proves none and records none
        assert calls == [] and tqp.cert_tier_counts("ns") == {"fast": 6}
        assert jqp.cert_tier_counts("ns") == {}


def test_engine_compaction_matches_jax(engines):
    kind, rng, x, ids, jqp, tqp = engines
    ns = tqp.storage.namespace("ns")
    alive = [v for v in ids if ns.contains(v)]
    gone = alive[: len(alive) // 4]                  # above the 0.2 ratio: both compact
    jqp.delete(gone, "ns")
    tqp.delete(gone, "ns")
    assert ns._tombstones == 0
    st = ns.device_state()
    assert (st.mirror is st.data) == (kind == "same_dtype")
    bf = st.data[: st.high_water].double()
    assert torch.equal(st.sq_norms[: st.high_water], (bf * bf).sum(-1).float())
    queries = rng.standard_normal((8, D), dtype=np.float32)
    for metric in METRICS:
        _search_both(jqp, tqp, queries, 10, metric)
    for k in (1, 100):
        _search_both(jqp, tqp, queries, k, "l2")
