"""The int8 and f32 sweep mirrors of the port (``sweep_dtype="int8"``, with and without
``sweep_resid``, and ``sweep_dtype="float32"``: kernel B3's remaining variants, their
quantizers, certificate plans, store upkeep and engine dispatch) against the JAX package,
on the CPU.

The port's kernel wrappers run their plain torch versions on CPU tensors; the JAX side
runs its Pallas kernels in interpret mode.  Inputs are made with numpy from a seed.  The
JAX mirror is window-major [Dp, cap] and the port's row-major [cap, Dp]; both describe the
same windows of r1 consecutive store rows.

Tolerances:
  * int8 codes: bit-equal; scales equal to the JAX package's eager quantizers; error
    norms within sqrt(Dp) * 2^-23 relative (another summation order).  The JAX store's
    jitted upkeep computes the scales as max|x| * (1/127) and so may sit 1 ulp from the
    eager ones on some rows: held within 1 ulp there, codes still equal;
  * window mins: fully masked windows equal (exactly 3e38); live windows within the
    certificate's accumulation slack Dp * 2^-22 * |qh| * maxd per query (cosine:
    maxd = 1).  The products are exact for int8 codes against bf16 queries and round
    for the f32 mirror; both sides sum them in f32 in different orders;
  * pool positions: equal, except where the two sides order near-ties differently (the
    rule of tests/test_torch_topm.py);
  * searches: tiers equal to the JAX package's, id sets equal on gaussian data, sorted
    distances within 1e-4 relative + 1e-5 on clustered data.
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
from mlvectordb_tpu.store.namespace import NamespaceStore as JaxNamespaceStore
from mlvectordb_tpu.store.vector import Vector as JaxVector
from mlvectordb_tpu_torch import EngineConfig, NamespaceStore, QueryProcessor, VectorDTO, convert
from mlvectordb_tpu_torch.ops import fused_knn_t as T
from mlvectordb_tpu_torch.ops.distances import MASKED
from mlvectordb_tpu_torch.store.vector import Vector

from .test_torch_sweep import (_assert_same_distances, _assert_same_sets, _clustered,
                               _gaussian, _jax_rows, _l2_scale, _t)

D = 128
TILE = J.SWEEP_TILE
ULP = np.sqrt(D) * 2.0 ** -23


# ------------------------------------------------------------------ quantizers


def _quantizer_corpus():
    rng = np.random.default_rng(3)
    db = rng.standard_normal((8192, D)).astype(np.float32) * 3.0
    db[:8] = 0.0                                  # all-zero rows: scales 0, codes 0
    db[8] = rng.integers(-127, 128, D)            # s1 = 1, s1*z1 exact: s2 = 0, err2 = 0
    db[8, 0] = np.float32(127.0)
    # a half-unit tie: max 127 gives s1 = 1, and 0.5 / 2.5 / -1.5 round half to even
    db[9] = np.float32(0.0)
    db[9, :4] = np.array([127.0, 0.5, 2.5, -1.5], np.float32)
    return db


def test_int8_quantizers_match_jax():
    db = _quantizer_corpus()
    z, s, e = (np.asarray(x) for x in J.quantize_int8_rows(jnp.asarray(db)))
    tz, ts, te = (x.numpy() for x in T.quantize_int8_rows(_t(db)))
    assert tz.dtype == np.int8 and np.array_equal(tz, z)
    assert np.array_equal(ts, s) and (ts[:8] == 0).all() and (tz[:8] == 0).all()
    np.testing.assert_array_equal(tz[9, :4], [127, 0, 2, -2])
    assert np.all(np.abs(te - e) <= ULP * np.abs(e) + 1e-30)


def test_int8_resid_quantizers_match_jax():
    db = _quantizer_corpus()
    want = [np.asarray(x) for x in J.quantize_int8_resid_rows(jnp.asarray(db))]
    got = [x.numpy() for x in T.quantize_int8_resid_rows(_t(db))]
    for i in (0, 2):                              # z1, z2: bit-equal int8 codes
        assert got[i].dtype == np.int8 and np.array_equal(got[i], want[i])
    for i in (1, 3):                              # s1, s2: equal
        assert np.array_equal(got[i], want[i])
    assert got[3][8] == 0 and (got[2][8] == 0).all() and got[4][8] == 0
    for i in (4, 5):                              # e2, e1
        assert np.all(np.abs(got[i] - want[i]) <= ULP * np.abs(want[i]) + 1e-30)


# ------------------------------------------------------------------ kernel B3

PROGRAMS = ["int8_light", "int8_two_pass", "int8_resid", "f32"]
# (r1, outputs): block mins at r1 = 32; the pool with and without the window mins at
# r1 = 16 (m = 8); the window mins alone at r1 = 4
OUTPUTS = [(32, "block_mins"), (16, "pool"), (16, "pool_only"), (4, "window_mins")]


def _b3_operands(seed, n, b, metric, program):
    """Kernel B3's operands as the certified search builds them for ``program``, with ~1%
    tombstones and a dead half tile; the JAX side's and the port's, and the slack."""
    rng, db, q = _gaussian(seed, n, b)
    valid = rng.random(n) > 0.01
    valid[-TILE // 2:] = False
    sq = (db * db).sum(-1).astype(np.float32)
    int8 = program != "f32"
    z1, s1, z2, s2, e2, e1 = (x.numpy() for x in T.quantize_int8_resid_rows(_t(db)))
    wb = {"int8_light": ("err1", "sqn_sqrt"), "int8_two_pass": ("sweep_err",),
          "int8_resid": ("sweep_err", "err1"), "f32": ()}[program]
    use_resid = program == "int8_resid"
    prep = T._prep_terms(_t(valid), _t(sq), n, _t(s1), _t(e2), _t(e1), cap=n, metric=metric,
                         masked=True, use_resid=use_resid, wb_sources=wb, rscale2=_t(s2),
                         int8_sweep=int8)
    q_fold = (-2.0 if metric == "l2" else -1.0) * q
    qh = q_fold.astype(jnp.bfloat16).astype(np.float32) if int8 else q_fold
    qres = (q_fold - qh).astype(jnp.bfloat16).astype(np.float32) if program in (
        "int8_two_pass", "int8_resid") else None
    rows = {k: None if v is None else v.numpy() for k, v in prep.items()
            if k in ("bias_row", "scale_row", "rscale_row")}
    ebs = [e.numpy() for e in prep["eb_rows"]]
    qe = rng.random((b, len(ebs))).astype(np.float32) * 4.0 if ebs else None
    mirror = z1 if int8 else db
    resid = z2 if use_resid else None
    q_dt = jnp.bfloat16 if int8 else jnp.float32
    jax_args = (jnp.asarray(qh, q_dt), None if qres is None else jnp.asarray(qres, q_dt),
                J.to_sweep_layout(jnp.asarray(mirror)),
                None if resid is None else J.to_sweep_layout(jnp.asarray(resid)),
                _jax_rows(rows["rscale_row"]), _jax_rows(rows["scale_row"]),
                _jax_rows(rows["bias_row"]))
    jax_kw = dict(qe=None if qe is None else jnp.pad(jnp.asarray(qe), ((0, 0), (0, 128 - len(ebs)))),
                  eb_rows=tuple(_jax_rows(e) for e in ebs))
    t_dt = torch.bfloat16 if int8 else torch.float32
    torch_args = (_t(qh).to(t_dt), None if qres is None else _t(qres).to(t_dt), _t(mirror),
                  None if resid is None else _t(resid),
                  None if rows["rscale_row"] is None else _t(rows["rscale_row"]),
                  None if rows["scale_row"] is None else _t(rows["scale_row"]),
                  _t(rows["bias_row"]))
    torch_kw = dict(qe=None if qe is None else _t(qe), eb_rows=tuple(map(_t, ebs)))
    maxd = 1.0 if metric == "cosine" else float(np.sqrt(sq[valid].max()))
    slack = D * 2.0 ** -22 * np.linalg.norm(q_fold, axis=1) * maxd
    return (jax_args, jax_kw), (torch_args, torch_kw), slack


def _assert_within_slack(got, want, slack, some_dead=True):
    dead = want == MASKED
    assert (~dead).any() and (dead.any() or not some_dead)
    np.testing.assert_array_equal(got[dead], want[dead])
    err = np.where(dead, 0.0, np.abs(got - want))
    assert (err <= slack).all(), float((err / slack).max())


@pytest.mark.parametrize("r1,outputs", OUTPUTS)
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("program", PROGRAMS)
def test_b3_plain_matches_pallas(program, metric, r1, outputs):
    n, b, m = 2 * TILE, 8, 8
    g = 32 // r1
    (ja, jk), (ta, tk), slack = _b3_operands(r1 * 7 + len(metric) + len(program), n, b,
                                             metric, program)
    opts = dict(emit_block_mins=outputs == "block_mins",
                emit_topm=m if outputs.startswith("pool") else 0,
                skip_wm=outputs == "pool_only")
    want = J._window_mins(*ja, q_tile=b, g=g, transposed=True, **opts, **jk)
    launches = T._window_mins_t.launches
    wmin, bm, pool = T._window_mins_t(*ta, r1=r1, **opts, **tk)
    assert T._window_mins_t.launches == launches         # CPU tensors: the plain version
    if outputs == "window_mins":
        _assert_within_slack(wmin.numpy(), np.asarray(want), slack[None, :, None])
        return
    if outputs == "block_mins":
        w_wmin, w_bm = (np.asarray(x) for x in want)
        _assert_within_slack(wmin.numpy(), w_wmin, slack[None, :, None])
        _assert_within_slack(bm.numpy(), w_bm[:, 0, :], slack[None, :], some_dead=False)
        return
    assert (wmin is None) == opts["skip_wm"] and bm is None
    w_pool = np.asarray(want if opts["skip_wm"] else want[1])
    own = (wmin if wmin is not None else T._window_mins_t(*ta, r1=r1, **tk)[0]).numpy()
    if not opts["skip_wm"]:
        _assert_within_slack(own, np.asarray(want[0]), slack[None, :, None])
    got = pool.numpy()
    np.testing.assert_array_equal(got[:, m + m // 2:], w_pool[:, m + m // 2:])
    gv, gp = (x.numpy() for x in T._decode_topm(pool, m, g * 128))
    wv, wp = (x.numpy() for x in T._decode_topm(_t(w_pool), m, g * 128))
    _assert_within_slack(gv, wv, slack[None, None, :], some_dead=False)
    # positions: equal unless JAX's pick is a near-tie of the port's in the port's mins
    t_i, j_i, b_i = np.nonzero(gp != wp)
    assert (np.abs(own[t_i, b_i, wp[t_i, j_i, b_i]] - gv[t_i, j_i, b_i])
            <= 2 * slack[b_i]).all()
    assert len(t_i) <= gp.size // 20, len(t_i)


def test_b3_operand_checks():
    n, b = 2 * TILE, 8
    bias = torch.zeros(n)
    q16, q32 = torch.zeros((b, D), dtype=torch.bfloat16), torch.zeros((b, D))
    codes, rows = torch.zeros((n, D), dtype=torch.int8), torch.zeros((n, D))
    s = torch.ones(n)

    def check(qh, mirror, qres=None, resid=None, rscale=None, bias_row=bias):
        T._check_sweep_operands(qh, qres, mirror, resid, rscale, None, bias_row, None, (),
                                32, False)

    check(q16, codes)                                   # int8: one pass,
    check(q16, codes, qres=q16)                         # two_pass,
    check(q16, codes, qres=q16, resid=codes, rscale=s)  # and both
    check(q16, codes, bias_row=None)                    # no bias row (the probe's kA)
    check(q32, rows)                                    # f32: one pass
    for bad in (dict(qh=q32, mirror=codes),             # int8 ranks bf16 queries
                dict(qh=q16, mirror=codes, resid=codes, rscale=s),  # resid needs two_pass
                dict(qh=q16, mirror=rows),              # f32 ranks f32 queries
                dict(qh=q32, mirror=rows, qres=q32),    # f32 has one pass
                dict(qh=q16, mirror=torch.zeros((n, D), dtype=torch.float16))):
        with pytest.raises(ValueError):
            check(**bad)


# ------------------------------------------------------------------ searches


def _both(db, q, valid, *, metric, k, mirror, resid=True, light=False, live_prefix=None,
          **kw):
    """The same certified search through the JAX entry (interpret mode) and the port's,
    over an int8 (with or without the second stream) or an f32 mirror: ((dist, idx, tier)
    of JAX, of the port) as numpy arrays and ints."""
    n = db.shape[0]
    sq = (db * db).sum(-1).astype(np.float32)
    lp = n if live_prefix is None and valid.all() else live_prefix
    jdb = jnp.asarray(db)
    if mirror == "f32":
        jm, jarr = J.to_sweep_layout(jdb), {}
        tm, tarr = _t(db), {}
    elif resid:
        z1, s1, z2, s2, e2, e1 = J.quantize_int8_resid(jdb)
        jm, jarr = z1, dict(sweep_err=e2, resid=z2, rscale=s1, err1=e1, rscale2=s2)
        tz1, ts1, tz2, ts2, te2, te1 = T.quantize_int8_resid_rows(_t(db))
        tm, tarr = tz1, dict(sweep_err=te2, resid=tz2, rscale=ts1, err1=te1, rscale2=ts2)
    else:
        z, s, e = J.quantize_int8(jdb)
        jm, jarr = z, dict(sweep_err=e, rscale=s)
        tz, ts, te = T.quantize_int8_rows(_t(db))
        tm, tarr = tz, dict(sweep_err=te, rscale=ts)
    jd, ji, jt = J.exact_knn_pallas_t(
        jnp.asarray(q), jm, jdb, jnp.asarray(valid), jnp.asarray(sq), k=k, metric=metric,
        live_prefix=lp, light=light, report_tier=True, **jarr, **kw)
    td, ti, tt = T.exact_knn_t(
        _t(q), tm, _t(db), _t(valid), _t(sq), k=k, metric=metric, live_prefix=lp,
        light=light, report_tier=True, **tarr, **kw)
    return (np.asarray(jd), np.asarray(ji), int(jt)), (td.numpy(), ti.numpy(), tt)


@pytest.mark.parametrize("mirror", ["int8", "f32"])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_gaussian_search_matches_jax(mirror, metric, oracle):
    _, db, q = _gaussian(201 + len(metric), 4 * TILE, 8)
    j, t = _both(db, q, np.ones(4 * TILE, bool), metric=metric, k=10, mirror=mirror)
    assert t[2] == j[2] == 0
    _assert_same_sets(j, t, oracle(q, db, 10, metric)[1])


@pytest.mark.parametrize("mirror", ["int8", "f32"])
def test_tombstoned_search_matches_jax(mirror):
    rng, db, q = _gaussian(205, 4 * TILE, 16)
    valid = rng.random(4 * TILE) > 0.05
    q = db[:16] + np.float32(1e-3)                # the nearest rows are the queried ones...
    valid[:16:2] = False                          # ...and every other one of them is dead
    j, t = _both(db, q, valid, metric="l2", k=10, mirror=mirror)
    assert t[2] == j[2]
    _assert_same_sets(j, t)
    assert valid[t[1]].all()


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_clustered_int8_resid_certifies_like_jax(metric):
    """The clustered corpus of tests/test_pallas_t.py:339-368 (16 centres x 4, noise
    0.02): the two int8 streams' band certifies where the first stream's alone cannot."""
    _, db, q = _clustered(211, 2 * TILE, 8, 16, 4.0, 0.02)
    j, t = _both(db, q, np.ones(2 * TILE, bool), metric=metric, k=10, mirror="int8")
    assert t[2] == j[2]
    _assert_same_distances(j, t, _l2_scale(db, q) if metric == "l2" else None)


@pytest.mark.parametrize("corpus", ["gaussian", "clustered"])
def test_int8_without_resid_tier_matches_jax(corpus):
    """One int8 stream: its band (~2x bf16's) certifies gaussian neighbour gaps at this
    size on both sides, and fails on the clustered corpus, where both escalate (the
    escalation docs/NEXT.md:52-53 reports for gaussian data at 2^20 rows on the TPU)."""
    if corpus == "gaussian":
        _, db, q = _gaussian(221, 16 * TILE, 8)
    else:
        _, db, q = _clustered(222, 2 * TILE, 8, 16, 4.0, 0.02)
    j, t = _both(db, q, np.ones(db.shape[0], bool), metric="l2", k=10, mirror="int8",
                 resid=False)
    assert t[2] == j[2] == (0 if corpus == "gaussian" else 2)
    _assert_same_distances(j, t, _l2_scale(db, q))
    if corpus == "gaussian":
        _assert_same_sets(j, t)


def test_int8_light_program_matches_jax():
    """The one-pass int8 program, which only a direct call takes (the engine never serves
    an int8 mirror light): the raw band on err1, uncompensated query rounding."""
    _, db, q = _gaussian(225, 4 * TILE, 8)
    j, t = _both(db, q, np.ones(4 * TILE, bool), metric="l2", k=10, mirror="int8",
                 light=True)
    assert t[2] == j[2]
    _assert_same_sets(j, t)


@pytest.mark.parametrize("mirror", ["int8", "f32"])
def test_k100_pool_program_matches_jax(mirror):
    """32 tiles, k=100: the k bucket 128 program, with the top-m pool (m=16, g=2)."""
    _, db, q = _gaussian(231, 32 * TILE, 8)
    launches = T._window_mins_t.launches_topm
    calls = []
    real = T._window_mins_t

    def spy(*a, **kw):
        calls.append(kw["emit_topm"])
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "_window_mins_t", spy)
        j, t = _both(db, q, np.ones(32 * TILE, bool), metric="l2", k=100, mirror=mirror)
    assert t[2] == j[2] == 0 and calls == [16]
    _assert_same_sets(j, t)
    assert T._window_mins_t.launches_topm == launches    # CPU tensors: the plain version


def test_int8_mirror_without_scales_goes_to_scan():
    _, db, q = _gaussian(235, 2 * TILE, 4)
    z, _, _ = T.quantize_int8_rows(_t(db))
    n = 2 * TILE
    _, _, tier = T.exact_knn_t(_t(q), z, _t(db), torch.ones(n, dtype=torch.bool),
                               _t((db * db).sum(-1)), k=5, metric="l2", live_prefix=n,
                               report_tier=True)
    assert tier == -1


def test_plan_and_prep_follow_the_mirror():
    n = 2 * TILE
    _, db, _ = _gaussian(237, n, 4)
    z1, s1, z2, s2, e2, e1 = T.quantize_int8_resid_rows(_t(db))
    sq, valid = _t((db * db).sum(-1)), torch.ones(n, dtype=torch.bool)
    plan = dict(certify=True, light=False, metric="cosine", rescan_dtype=torch.float32,
                sweep_err=e2, resid=z2, rscale=s1, err1=e1)
    assert T._plan(mirror_dtype=torch.int8, rscale2=s2, **plan) == (
        True, ("sweep_err", "err1"), ("qh", "qres"), ())
    # without the second scale the residual pass is off (pallas_knn_t.py:1524)
    assert T._plan(mirror_dtype=torch.int8, rscale2=None, **plan)[0] is False
    assert T._plan(mirror_dtype=torch.float32, rscale2=None, **plan) == (False, (), (), ())
    prep = T.search_prep(z1, valid, sq, metric="cosine", live_prefix=n, sweep_err=e2,
                         resid=z2, rscale=s1, err1=e1, rscale2=s2)
    inv = torch.rsqrt(sq)
    assert torch.equal(prep["scale_row"], s1 * inv)
    assert torch.equal(prep["rscale_row"], torch.where(s1 > 0, s2 / s1, 0.0))
    f32 = T.search_prep(_t(db), valid, sq, metric="l2", live_prefix=n)
    assert f32["scale_row"] is None and f32["rscale_row"] is None and f32["eb_rows"] == ()
    for mirror in ("int8", "f32"):
        qh, qres, _ = T._fold_query(_t(db[:4]), "l2", False,
                                    torch.int8 if mirror == "int8" else torch.float32)
        assert qh.dtype == (torch.bfloat16 if mirror == "int8" else torch.float32)
        assert (qres is None) == (mirror == "f32")
    # the prep cache keys on the mirror's type: an int8 and an f32 search share no entry
    cache = {}
    for m in (z1, _t(db)):
        T.exact_knn_t(_t(db[:8]), m, _t(db), valid, sq, k=5, metric="l2", live_prefix=n,
                      sweep_err=e2 if m.dtype == torch.int8 else None,
                      rscale=s1 if m.dtype == torch.int8 else None, prep_cache=cache)
    assert len(cache) == 2


# ------------------------------------------------------------------ store upkeep


def _int8_config(cls, resid, **kw):
    return cls(initial_capacity=4096, capacity_multiple=4096, sweep_dtype="int8",
               sweep_resid=resid, **kw)


_INT8_NAMES = {True: ("mirror", "sweep_rscale", "sweep_resid", "sweep_rscale2", "sweep_err",
                      "sweep_err1"),
               False: ("mirror", "sweep_rscale", "sweep_err")}


def _assert_store_matches_jax(jns, tns, *, rebuilt):
    """The port's int8 arrays against the JAX store's.

    Both stores hold the same rows.  At every step the port's arrays are its quantizer's
    on those rows, and that quantizer is the JAX package's eager one: codes and scales
    bit for bit, norms within sqrt(Dp) ulps.  The JAX store's own arrays (carried over
    by ``convert.sweep_arrays_from_jax``) equal them after a whole-store rebuild
    (``rebuilt``: compaction quantizes eagerly).  Its jitted write upkeep is another
    program: XLA multiplies by 1/127 (s1 up to 1 ulp off, so a code at a half-unit tie
    may flip) and fuses row - s1*z1 into one FMA (s2 a few hundred ulps off, z2 codes
    one unit off at near-ties; ROADMAP §C).  There: z1 equal wherever s1 is, s2 within
    2^-14 and z2 within one unit on at most 0.1% of the codes where z1 is equal."""
    resid = tns.device_state().sweep_resid is not None
    names = _INT8_NAMES[resid]
    st = tns.device_state()
    np.testing.assert_array_equal(st.data.numpy(), np.asarray(jns._data))
    mine = T.quantize_int8_resid_rows(st.data) if resid else T.quantize_int8_rows(st.data)
    for name, want in zip(names, mine):
        assert torch.equal(getattr(st, name), want), name
    eager = (J.quantize_int8_resid_rows if resid else J.quantize_int8_rows)(jns._data)

    def same(got, want, name):
        """Codes and scales equal; the norms within sqrt(Dp) ulps."""
        got, want = np.asarray(got), np.asarray(want)
        if name in ("sweep_err", "sweep_err1"):
            assert (np.abs(got - want) <= ULP * np.abs(want) + 1e-30).all(), name
        else:
            assert np.array_equal(got, want), name

    for name, want in zip(names, eager):
        same(getattr(st, name).numpy(), want, name)
    carried = convert.sweep_arrays_from_jax(
        np.asarray(jns._data_t), None if jns._sweep_resid is None else np.asarray(
            jns._sweep_resid), np.asarray(jns._sweep_err), np.asarray(jns._sweep_rscale),
        None if jns._sweep_err1 is None else np.asarray(jns._sweep_err1),
        None if jns._sweep_rscale2 is None else np.asarray(jns._sweep_rscale2),
        device="cpu")
    if rebuilt:
        for name in names:
            same(getattr(st, name).numpy(), carried[name].numpy(), name)
        return
    z1, jz1 = st.mirror.numpy(), carried["mirror"].numpy()
    s1, js1 = st.sweep_rscale.numpy(), carried["sweep_rscale"].numpy()
    assert (np.abs(s1.view(np.int32) - js1.view(np.int32)) <= 1).all()
    flipped = (z1 != jz1).any(1)
    assert not (flipped & (s1 == js1)).any() and (np.abs(z1 - jz1.astype(int)) <= 1).all()
    if resid:
        same = ~flipped
        s2, js2 = st.sweep_rscale2.numpy()[same], carried["sweep_rscale2"].numpy()[same]
        assert (np.abs(s2 - js2) <= 2.0 ** -14 * js2).all()
        dz2 = np.abs(st.sweep_resid.numpy()[same].astype(int) - carried["sweep_resid"].numpy()[same])
        assert dz2.max() <= 1 and (dz2 != 0).mean() <= 1e-3


@pytest.mark.parametrize("resid", [True, False])
def test_int8_store_upkeep_matches_jax(resid):
    rng = np.random.default_rng(241 + resid)
    jns = JaxNamespaceStore("w", _int8_config(JaxConfig, resid, use_pallas=False))
    tns = NamespaceStore("w", _int8_config(EngineConfig, resid), device="cpu")
    x = rng.standard_normal((3000, D), dtype=np.float32) * 2.0
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    for ns in (jns, tns):
        ns.bulk_upsert(x, ids)
    _assert_store_matches_jax(jns, tns, rebuilt=False)    # bulk load
    more = rng.standard_normal((3000, D), dtype=np.float32)
    more_ids = [uuid.UUID(int=i + 10_000) for i in range(len(more))]
    over = rng.standard_normal((4, D), dtype=np.float32)
    for ns, vec in ((jns, JaxVector), (tns, Vector)):
        ns.bulk_upsert(more, more_ids)                     # growth past the first tile
        ns.upsert([vec(v, {}, id=ids[i]) for i, v in zip((5, 17, 2999, 0), over)])
    assert tns.capacity == jns.capacity == 8192
    _assert_store_matches_jax(jns, tns, rebuilt=False)
    for ns in (jns, tns):
        ns.delete(ids[:500])                               # tombstones, below the ratio
    assert tns._tombstones == 500 and tns.capacity == 8192
    _assert_store_matches_jax(jns, tns, rebuilt=False)
    for ns in (jns, tns):
        ns.delete(ids[500:2500])                           # above it: compaction
    assert tns._tombstones == 0 and tns.capacity == jns.capacity == 4096
    _assert_store_matches_jax(jns, tns, rebuilt=True)
    st = tns.device_state()
    arrays = [st.data, st.valid, st.sq_norms, st.mirror, st.sweep_err, st.sweep_rscale,
              st.sweep_resid, st.sweep_err1, st.sweep_rscale2]
    assert tns.nbytes == sum(t.numel() * t.element_size() for t in arrays if t is not None)
    assert tns.nbytes == 4096 * (D * 4 + 5) + 4096 * (D + 8) + (4096 * (D + 8) if resid else 0)


def test_f32_mirror_is_the_row_store():
    """The f32 mirror holds the rows' own bytes in their own layout: the port keeps one
    tensor (ROADMAP §C), where the JAX store keeps a transposed copy."""
    rng = np.random.default_rng(251)
    cfg = dict(initial_capacity=4096, capacity_multiple=4096, sweep_dtype="float32")
    jns = JaxNamespaceStore("f", JaxConfig(use_pallas=False, **cfg))
    tns = NamespaceStore("f", EngineConfig(**cfg), device="cpu")
    x = rng.standard_normal((5000, D), dtype=np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(len(x))]
    for ns in (jns, tns):
        ns.bulk_upsert(x, ids)
        ns.delete(ids[:100])
    st = tns.device_state()
    assert st.mirror is st.data and st.sweep_err is None and st.sweep_resid is None
    carried = convert.sweep_arrays_from_jax(np.asarray(jns._data_t), device="cpu")
    assert carried["mirror"].dtype == torch.float32 and torch.equal(carried["mirror"], st.data)
    assert tns.nbytes == 8192 * (D * 4 + 5)               # the rows once, valid, sq_norms
    assert jns.nbytes == 8192 * (D * 4 + 5) + 8192 * D * 4
    small = NamespaceStore("s", EngineConfig(sweep_dtype="float32", initial_capacity=1024,
                                             capacity_multiple=512), device="cpu")
    small.bulk_upsert(x[:10])                             # below a tile: no mirror at all
    assert small.device_state().mirror is None


def test_carry_over_from_jax_int8_store():
    rng = np.random.default_rng(255)
    x = rng.standard_normal((9000, D), dtype=np.float32) * 2.0
    jns = JaxNamespaceStore("w", JaxConfig(sweep_dtype="int8"))
    jns.bulk_upsert(x, [uuid.UUID(int=i + 1) for i in range(len(x))])
    tns = convert.store_from_jax_snapshot(jns.snapshot_arrays(), EngineConfig(sweep_dtype="int8"),
                                          "cpu")
    assert tns.capacity == jns.capacity == 16384
    _assert_store_matches_jax(jns, tns, rebuilt=False)
    q = rng.standard_normal((8, D), dtype=np.float32)
    st, ts = jns.device_state(), tns.device_state()
    jd, ji, jt = J.exact_knn_pallas_t(
        jnp.asarray(q), st.data_t, st.data, st.valid, st.sq_norms, k=10, metric="l2",
        live_prefix=st.high_water, sweep_err=st.sweep_err, resid=st.sweep_resid,
        rscale=st.sweep_rscale, err1=st.sweep_err1, rscale2=st.sweep_rscale2,
        report_tier=True)
    td, ti, tt = T.exact_knn_t(
        _t(q), ts.mirror, ts.data, ts.valid, ts.sq_norms, k=10, metric="l2",
        live_prefix=ts.high_water, sweep_err=ts.sweep_err, resid=ts.sweep_resid,
        rscale=ts.sweep_rscale, err1=ts.sweep_err1, rscale2=ts.sweep_rscale2,
        report_tier=True)
    assert tt == int(jt) == 0
    for b in range(8):
        assert set(ti[b].tolist()) == set(np.asarray(ji)[b].tolist())


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module", params=["int8", "int8_no_resid", "float32"])
def engines(request):
    """One sweep namespace of 20,000 gaussian rows and one clustered one in the JAX engine
    and in the port's (on the CPU).  The JAX engine picks its certified sweep backend only
    on a TPU; here it is told it runs on one, and its Pallas kernels still run in
    interpret mode."""
    rng = np.random.default_rng(261)
    x = rng.standard_normal((20_000, D), dtype=np.float32)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, len(x))]
    _, xc, qc = _clustered(262, 3 * TILE, 16, 16, 4.0, 0.02)
    cfg = dict(sweep_dtype=request.param.split("_")[0],
               sweep_resid=request.param != "int8_no_resid")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backend, "jax", types.SimpleNamespace(default_backend=lambda: "tpu"))
        jqp = JaxQueryProcessor(config=JaxConfig(**cfg))
        tqp = QueryProcessor(EngineConfig(**cfg), device="cpu")
        for qp in (jqp, tqp):
            qp.bulk_load(x, "ns", ids=ids)
            qp.bulk_load(xc, "c")
        yield request.param, rng, ids, jqp, tqp, qc


def _search_both(jqp, tqp, queries, k, metric, ns="ns", scale=None):
    """Ids equal (gaussian) or, on clustered data with ties, the sorted scores within
    1e-4 + the f32 cancellation of l2's expansion (16 ulps of ``scale`` per query)."""
    jr = jqp.find_similar_batch([JaxDTO(v) for v in queries], k, ns, metric)
    tr = tqp.find_similar_batch([VectorDTO(v) for v in queries], k, ns, metric)
    for i, (a, b) in enumerate(zip(jr, tr)):
        if scale is None:
            assert {r["id"] for r in a} == {r["id"] for r in b}
        atol = 1e-4 if scale is None else 1e-4 + 16 * 2.0 ** -24 * scale[i]
        np.testing.assert_allclose(sorted(r["score"] for r in b),
                                   sorted(r["score"] for r in a), rtol=1e-4, atol=atol)
    return tr


def test_engine_matches_jax_before_and_after_deletes(engines):
    kind, rng, ids, jqp, tqp, _ = engines
    assert tqp.storage.namespace("ns").device_state().mirror.dtype == (
        torch.float32 if kind == "float32" else torch.int8)
    queries = rng.standard_normal((16, D), dtype=np.float32)
    for metric in ("l2", "ip", "cosine"):
        before, tiers = dict(tqp.transfer_counts), tqp.cert_tier_counts("ns")
        _search_both(jqp, tqp, queries, 10, metric)
        xfer = (tqp.transfer_counts["h2d"] - before["h2d"],
                tqp.transfer_counts["d2h"] - before["d2h"])
        served = [t for t, c in tqp.cert_tier_counts("ns").items() if c != tiers.get(t, 0)]
        # one copy each way at tier 0; the port counts an escalation's own copies (the
        # JAX package escalates inside its one program)
        assert xfer == (1, 1) if served == ["fast"] else xfer[0] == 1 and xfer[1] >= 2
    gone = [ids[i] for i in rng.choice(len(ids), 300, replace=False)]
    assert sorted(map(str, jqp.delete(gone, "ns"))) == sorted(map(str, tqp.delete(gone, "ns")))
    for metric in ("l2", "ip", "cosine"):
        tr = _search_both(jqp, tqp, queries, 10, metric)
        assert not {r["id"] for rs in tr for r in rs} & set(gone)
    assert tqp.cert_tier_counts("ns") == jqp.cert_tier_counts("ns")
    if kind != "int8_no_resid":
        assert tqp.cert_tier_counts("ns") == {"fast": 6}


def test_engine_never_serves_int8_or_f32_light(engines):
    """A clustered namespace, where the bf16 mirror's light program escalates and flips:
    an int8 or f32 store runs its one program, never a light_ tier, and never flips."""
    kind, _, _, jqp, tqp, qc = engines
    xc = tqp.storage.namespace("c").device_state().data.numpy()
    scale = _l2_scale(xc, qc)
    calls = []
    real = T._window_mins_t

    def spy(qh, qres, mirror, resid, *a, **kw):
        calls.append((mirror.dtype, qres is not None, resid is not None))
        return real(qh, qres, mirror, resid, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "_window_mins_t", spy)
        for i in range(2):     # distinct queries: the result cache serves none
            _search_both(jqp, tqp, qc + np.float32(i * 1e-4), 10, "l2", ns="c", scale=scale)
    want = {"int8": (torch.int8, True, True), "int8_no_resid": (torch.int8, True, False),
            "float32": (torch.float32, False, False)}[kind]
    assert calls == [want, want]
    assert tqp.cert_tier_counts("c") == jqp.cert_tier_counts("c")
    assert not any(t.startswith("light_") for t in tqp.cert_tier_counts("c"))
    assert tqp._cert_mode == {}
