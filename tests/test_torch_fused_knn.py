"""The module that holds the CUDA kernels (ops/fused_knn) against the JAX package.

On the CPU the kernel wrappers run their plain torch versions; those are held against
the JAX Pallas kernels run in interpret mode, as tests/test_pallas.py runs them.  The
window-min matrices compare element by element (same strided window layout) within
1e-5 * |x| + 1e-3: the same f32 arithmetic summed in another order, at D=128 and
distances up to a few hundred.  Fully masked windows are exactly 3e38 on both sides.
The CUDA kernels themselves are compared with the same plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import cpp_extension

from mlvectordb_tpu.ops import pallas_knn as jfused
from mlvectordb_tpu_torch.ops import _kernels
from mlvectordb_tpu_torch.ops import fused_knn as tfused
from mlvectordb_tpu_torch.ops.distances import MASKED

D = 128
B = 8
METRICS = ["l2", "ip", "cosine"]


def _corpus(seed, n, b=B):
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((n, D), dtype=np.float32)
    q = rng.standard_normal((b, D), dtype=np.float32)
    return rng, db, q


def _assert_window_mins_close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    dead = want == MASKED
    np.testing.assert_array_equal(got[dead], want[dead])
    live = ~dead
    assert (got[live] < MASKED).all()
    err = np.abs(got[live] - want[live])
    assert (err <= 1e-5 * np.abs(want[live]) + 1e-3).all(), float(err.max())


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("r1", [8, 16, 32])
@pytest.mark.parametrize("n", [8192, 16384])
def test_window_mins_fast_plain_matches_pallas(n, r1, metric):
    _, db, q = _corpus(n + r1, n)
    # a strided window spans its whole tile: the unwritten tail kills every window of
    # the last tile and cuts through the windows of the one before
    hw = n - tfused.DB_TILE - 1000
    qn = (q * q).sum(-1)[None, :]
    want = jfused._window_mins_fast(
        jnp.asarray(db), jnp.asarray(q.T), jnp.asarray(qn), jnp.asarray([[hw]], jnp.int32),
        metric=metric, q_tile=B, db_tile=jfused.DB_TILE, r1=r1,
    )
    launches = tfused._window_mins_fast.launches
    got = tfused._window_mins_fast(
        torch.from_numpy(db), torch.from_numpy(np.ascontiguousarray(q.T)),
        torch.from_numpy(qn), hw, metric=metric, db_tile=tfused.DB_TILE, r1=r1,
    )
    assert tfused._window_mins_fast.launches == launches  # CPU tensors: plain version
    _assert_window_mins_close(got.numpy(), np.asarray(want))
    assert (np.asarray(want) == MASKED).any()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("r1", [8, 16, 32])
@pytest.mark.parametrize("n", [8192, 16384])
def test_window_mins_masked_plain_matches_pallas(n, r1, metric):
    rng, db, q = _corpus(2 * n + r1, n)
    valid = rng.random(n) > 0.01   # ~1% tombstones
    valid[-tfused.DB_TILE :] = False  # and a dead last tile: fully masked windows
    maskadd = np.where(valid, 0.0, MASKED).astype(np.float32)
    sq = (db * db).sum(-1)
    bias = ((sq + maskadd) if metric == "l2" else maskadd).astype(np.float32)[:, None]
    qn = (q * q).sum(-1)[None, :]
    want = jfused._window_mins_masked(
        jnp.asarray(db), jnp.asarray(q.T), jnp.asarray(qn), jnp.asarray(bias),
        metric=metric, q_tile=B, db_tile=jfused.DB_TILE, r1=r1,
    )
    got = tfused._window_mins_masked(
        torch.from_numpy(db), torch.from_numpy(np.ascontiguousarray(q.T)),
        torch.from_numpy(qn), torch.from_numpy(bias), metric=metric,
        db_tile=tfused.DB_TILE, r1=r1,
    )
    _assert_window_mins_close(got.numpy(), np.asarray(want))
    assert (np.asarray(want) == MASKED).any()


def test_pick_r1_and_constants_match_jax():
    assert (tfused.R2, tfused.DB_TILE, tfused.Q_TILE) == (jfused.R2, jfused.DB_TILE, jfused.Q_TILE)
    for b in (1, 8, 32, 64, 128, 512, 4096):
        for n in (8192, 1 << 20, 1 << 24):
            for k in (1, 10, 16, 100, 1024):
                assert tfused._pick_r1(b, n, k) == jfused._pick_r1(b, n, k)


def _knn_inputs(seed, n, b, valid):
    _, db, q = _corpus(seed, n, b)
    sq = (db * db).sum(-1).astype(np.float32)
    j = (jnp.asarray(q), jnp.asarray(db), jnp.asarray(valid), jnp.asarray(sq))
    t = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (q, db, valid, sq))
    return q, db, j, t


def _assert_set_exact(td, ti, jd, ji, oracle_ids):
    for b in range(ti.shape[0]):
        assert set(ti[b].tolist()) == set(np.asarray(ji)[b].tolist()) == set(oracle_ids[b].tolist())
    np.testing.assert_allclose(np.sort(td, 1), np.sort(np.asarray(jd), 1), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", METRICS)
def test_exact_knn_fused_fast_matches_pallas_and_oracle(metric, oracle):
    n = 2 * tfused.DB_TILE
    q, db, j, t = _knn_inputs(11, n, 8, np.ones(n, bool))
    jd, ji = jfused.exact_knn_pallas(*j, k=5, metric=metric, live_prefix=n)
    td, ti = tfused.exact_knn_fused(*t, k=5, metric=metric, live_prefix=n)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32 and ti.shape == (8, 5)
    _, oi = oracle(q, db, 5, metric)
    _assert_set_exact(td.numpy(), ti.numpy(), jd, ji, oi)


@pytest.mark.parametrize("metric", METRICS)
def test_exact_knn_fused_masked_excludes_tombstones(metric, oracle):
    n = 4 * tfused.DB_TILE
    rng = np.random.default_rng(12)
    valid = rng.random(n) > 0.05
    q, db, j, t = _knn_inputs(12, n, 64, valid)
    q_near = db[:64] + np.float32(1e-3)  # the nearest rows are the queried ones...
    valid[:64:2] = False                 # ...and every other one of them is dead
    j = (jnp.asarray(q_near), j[1], jnp.asarray(valid), j[3])
    t = (torch.from_numpy(q_near), t[1], torch.from_numpy(valid), t[3])
    jd, ji = jfused.exact_knn_pallas(*j, k=10, metric=metric, live_prefix=None)
    td, ti = tfused.exact_knn_fused(*t, k=10, metric=metric, live_prefix=None)
    live = np.flatnonzero(valid)
    _, oi = oracle(q_near, db[live], 10, metric)
    _assert_set_exact(td.numpy(), ti.numpy(), jd, ji, live[oi])
    assert not (~valid[ti.numpy()]).any()


def test_exact_knn_fused_masks_unwritten_tail(oracle):
    n, hw = 2 * tfused.DB_TILE, 1000
    valid = np.zeros(n, bool)
    valid[:hw] = True
    q, db, j, t = _knn_inputs(13, n, 8, valid)
    jd, ji = jfused.exact_knn_pallas(*j, k=7, metric="l2", live_prefix=hw)
    td, ti = tfused.exact_knn_fused(*t, k=7, metric="l2", live_prefix=hw)
    _, oi = oracle(q, db[:hw], 7, "l2")
    _assert_set_exact(td.numpy(), ti.numpy(), jd, ji, oi)
    assert (ti.numpy() < hw).all()


def test_exact_knn_fused_batch_not_multiple_of_four(oracle):
    # the kernels take batches in multiples of 4: the wrapper pads and slices back
    n = 2 * tfused.DB_TILE
    q, db, j, t = _knn_inputs(14, n, 6, np.ones(n, bool))
    jd, ji = jfused.exact_knn_pallas(*j, k=4, metric="cosine", live_prefix=n)
    td, ti = tfused.exact_knn_fused(*t, k=4, metric="cosine", live_prefix=n)
    assert ti.shape == (6, 4)
    _, oi = oracle(q, db, 4, "cosine")
    _assert_set_exact(td.numpy(), ti.numpy(), jd, ji, oi)


@pytest.mark.parametrize("live", [True, False])
def test_exact_knn_fused_l2_rescan_is_jax_formula(live):
    """The row-major l2 rescan scores max(qn + ||row||^2 - 2 q.row, 0), as the JAX
    package's _select_and_rescan does (pallas_knn.py:260-262), and the port settles the
    top k in float64 (ROADMAP C18).  Integer rows keep every norm and dot exact in f32
    whatever the summation order, while qn + ||row||^2 passes 2^24 and rounds once: JAX
    returns that expansion bit for bit, in its order; the port returns the same rows with
    fl32 of their exact distances, in their exact order, which the expansion's rounding
    does not reach."""
    n, b = 2 * tfused.DB_TILE, 8
    rng = np.random.default_rng(16)
    db = rng.integers(-500, 501, (n, D)).astype(np.float32)
    near = rng.choice(n, b, replace=False)
    q = db[near] + rng.integers(-3, 4, (b, D)).astype(np.float32)
    valid = np.ones(n, bool) if live else rng.random(n) > 0.05
    valid[near] = True
    sq = (db * db).sum(-1).astype(np.float32)
    assert (sq < 2**24).all() and ((q * q).sum(-1)[:, None] + sq[None, :] > 2**24).all()
    lp = n if live else None
    jd, ji = jfused.exact_knn_pallas(jnp.asarray(q), jnp.asarray(db), jnp.asarray(valid),
                                     jnp.asarray(sq), k=10, metric="l2", live_prefix=lp)
    td, ti = tfused.exact_knn_fused(*(torch.from_numpy(a) for a in (q, db, valid, sq)), k=10,
                                    metric="l2", live_prefix=lp)
    jd, ji, td, ti = np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()
    assert [set(r) for r in ti.tolist()] == [set(r) for r in ji.tolist()]
    q64 = q.astype(np.float64)
    dots = np.einsum("bd,bkd->bk", q64, db[ji].astype(np.float64))
    qn = (q64 * q64).sum(-1)[:, None]
    expansion = np.maximum((qn + sq[ji]).astype(np.float32) - 2 * dots, 0).astype(np.float32)
    np.testing.assert_array_equal(jd, expansion)        # JAX: the f32 expansion, rounded once
    direct = ((db[ti].astype(np.float64) - q[:, None, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(td, direct.astype(np.float32))   # the port: fl32(float64)
    assert (np.diff(direct, axis=1) >= 0).all()         # in float64 order
    assert (ti[:, 0] == near).all() and valid[ti].all()
    assert (jd != ((db[ji].astype(np.float64) - q[:, None, :]) ** 2).sum(-1)).any()


def test_small_capacity_falls_back_to_scan():
    n = 256
    q, db, j, t = _knn_inputs(15, n, 4, np.ones(n, bool))
    jd, ji = jfused.exact_knn_pallas(*j, k=3, metric="l2", live_prefix=n)
    td, ti = tfused.exact_knn_fused(*t, k=3, metric="l2", live_prefix=n)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("nvcc", ["missing", "fails"])
def test_kernel_build_failure_raises(nvcc, tmp_path, monkeypatch):
    # no fallback: a missing or failing nvcc raises, naming the cause
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    if nvcc == "missing":
        monkeypatch.setattr(cpp_extension, "CUDA_HOME", str(tmp_path / "no-cuda"))
        match = "nvcc not found"
    else:
        monkeypatch.setattr(_kernels, "_nvcc", lambda: "false")
        match = "nvcc failed"
    with pytest.raises(RuntimeError, match=match):
        _kernels.build()
    assert list(tmp_path.iterdir()) == []  # no partial library left behind


def test_kernel_operand_checks():
    data = torch.zeros((8192, 128))
    qt = torch.zeros((128, 8))
    qn = torch.zeros((1, 8))
    assert tfused._check_operands(data, qt, qn, None, metric="l2", db_tile=4096, r1=8) == (
        8192, 128, 8)
    bad = [
        (data, torch.zeros((128, 6)), torch.zeros((1, 6)), None, "l2", 8),   # B % 4
        (data, qt, qn, None, "l2", 64),                                     # W % 128
        (data, qt.double(), qn, None, "l2", 8),                             # dtype
        (data, torch.zeros((8, 128)).T, qn, None, "l2", 8),                 # contiguity
        (data, qt, qn, torch.zeros((100, 1)), "l2", 8),                     # bias rows
        (data, qt, qn, None, "hamming", 8),                                 # metric
    ]
    for d, t, n, bias, metric, r1 in bad:
        with pytest.raises(ValueError):
            tfused._check_operands(d, t, n, bias, metric=metric, db_tile=4096, r1=r1)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("variant", ["fast", "masked"])
def test_nan_query_window_mins_match_pallas(variant, metric):
    """A NaN query: jnp.maximum / jnp.minimum propagate NaN, so its window mins are NaN
    wherever the JAX kernels' are (the CUDA kernels' rule since the repair: card tests in
    tests/test_torch_gpu.py); a dead row is MASKED whatever its distance (jnp.where), so
    a window past the high-water mark stays 3e38.  The other queries as before."""
    n, r1 = 16384, 8
    rng, db, q = _corpus(77 + len(metric), n)
    q[3, 11] = np.nan
    qn = (q * q).sum(-1)[None, :]
    tq = (torch.from_numpy(db), torch.from_numpy(np.ascontiguousarray(q.T)),
          torch.from_numpy(qn))
    jq = (jnp.asarray(db), jnp.asarray(q.T), jnp.asarray(qn))
    kw = dict(metric=metric, db_tile=tfused.DB_TILE, r1=r1)
    if variant == "fast":
        hw = n - tfused.DB_TILE - 1000
        want = jfused._window_mins_fast(*jq, jnp.asarray([[hw]], jnp.int32), q_tile=B, **kw)
        got = tfused._window_mins_fast(*tq, hw, **kw)
    else:
        valid = rng.random(n) > 0.01
        valid[-tfused.DB_TILE:] = False
        maskadd = np.where(valid, 0.0, MASKED).astype(np.float32)
        bias = ((db * db).sum(-1) + maskadd if metric == "l2" else maskadd)
        bias = bias.astype(np.float32)[:, None]
        want = jfused._window_mins_masked(*jq, jnp.asarray(bias), q_tile=B, **kw)
        got = tfused._window_mins_masked(*tq, torch.from_numpy(bias), **kw)
    got, want = got.numpy(), np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert nan[:, 3].any() and not np.delete(nan, 3, axis=1).any()
    if variant == "fast":
        assert (want[:, 3] == MASKED).any()          # whole windows past the high water
    live = np.delete(np.arange(B), 3)
    _assert_window_mins_close(got[:, live].copy(), want[:, live].copy())
