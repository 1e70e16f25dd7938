"""The torch port's distances and tiled scan against the JAX package's.

Both sides get the same numpy inputs (made from a seed).  Index sets must be equal and
distances agree to rtol = atol = 1e-4 (the tests/test_pallas.py convention): the same
f32 arithmetic, summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlvectordb_tpu.ops import distances as jdist
from mlvectordb_tpu.ops import topk as jtopk
from mlvectordb_tpu_torch.ops import distances as tdist
from mlvectordb_tpu_torch.ops import topk as ttopk

METRICS = ["l2", "ip", "cosine"]


def _inputs(seed, n, d=128, b=8, valid_frac=1.0):
    rng = np.random.default_rng(seed)
    db = rng.standard_normal((n, d), dtype=np.float32)
    q = rng.standard_normal((b, d), dtype=np.float32)
    sq = (db * db).sum(-1).astype(np.float32)
    valid = rng.random(n) < valid_frac
    return q, db, sq, valid


def _both_knn(q, db, sq, valid, *, k, metric, db_tile):
    jd, ji = jtopk.exact_knn(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(valid), jnp.asarray(sq),
        k=k, metric=metric, db_tile=db_tile,
    )
    td, ti = ttopk.exact_knn(
        torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(valid),
        torch.from_numpy(sq), k=k, metric=metric, db_tile=db_tile,
    )
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy())


def _assert_same(jax_out, torch_out):
    """Same live index sets per query (masked entries may name any masked slot)."""
    (jd, ji), (td, ti) = jax_out, torch_out
    assert td.dtype == np.float32 and ti.dtype == np.int32
    assert td.shape == jd.shape and ti.shape == ji.shape
    half = float(tdist.MASKED) / 2
    for b in range(jd.shape[0]):
        assert set(ti[b][td[b] < half].tolist()) == set(ji[b][jd[b] < half].tolist())
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_distances_match_jax(metric):
    q, db, sq, _ = _inputs(0, 300)
    qn = (q * q).sum(-1)
    jd = jdist.pairwise_distances(jnp.asarray(q), jnp.asarray(db), jnp.asarray(sq),
                                  jnp.asarray(qn), metric)
    td = tdist.pairwise_distances(torch.from_numpy(q), torch.from_numpy(db),
                                  torch.from_numpy(sq), torch.from_numpy(qn), metric)
    assert td.dtype == torch.float32 and td.shape == (8, 300)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)


def test_query_norms_and_masked_sentinel():
    q = np.random.default_rng(1).standard_normal((5, 128), dtype=np.float32)
    np.testing.assert_allclose(
        tdist.query_norms(torch.from_numpy(q)).numpy(),
        np.asarray(jdist.query_norms(jnp.asarray(q))), rtol=1e-6,
    )
    assert tdist.MASKED == jdist.MASKED and isinstance(tdist.MASKED, np.float32)


def test_unknown_metric_raises():
    q, db, sq, _ = _inputs(2, 16)
    with pytest.raises(ValueError):
        tdist.pairwise_distances(torch.from_numpy(q), torch.from_numpy(db),
                                 torch.from_numpy(sq), torch.from_numpy(sq[:8]), "hamming")


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [5, 300])
def test_exact_knn_matches_jax(metric, k):
    # k=300 takes the sort path of the tile fold (k > 256)
    q, db, sq, valid = _inputs(3, 2048)
    _assert_same(*_both_knn(q, db, sq, valid, k=k, metric=metric, db_tile=512))


@pytest.mark.parametrize("metric", METRICS)
def test_exact_knn_odd_capacity_and_masked_slots(metric):
    # capacity not a tile multiple (padded with masked slots) and ~30% dead slots
    q, db, sq, valid = _inputs(4, 1000, valid_frac=0.7)
    _assert_same(*_both_knn(q, db, sq, valid, k=7, metric=metric, db_tile=256))


def test_exact_knn_pads_to_k_with_masked_slots():
    # single tile, k larger than the capacity: padded with MASKED entries
    q, db, sq, valid = _inputs(5, 6)
    (jd, ji), (td, ti) = _both_knn(q, db, sq, valid, k=10, metric="l2", db_tile=64)
    assert (td[:, 6:] == tdist.MASKED).all() and (ti[:, 6:] == 0).all()
    _assert_same((jd, ji), (td, ti))


def test_exact_knn_matches_oracle(oracle):
    q, db, sq, valid = _inputs(6, 3000)
    td, ti = ttopk.exact_knn(torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(valid),
                             torch.from_numpy(sq), k=10, metric="l2", db_tile=1024)
    _, oi = oracle(q, db, 10, "l2")
    for b in range(q.shape[0]):
        assert set(ti[b].tolist()) == set(oi[b].tolist())


@pytest.mark.parametrize("k", [4, 300])
def test_merge_topk_matches_jax(k):
    rng = np.random.default_rng(7)
    da = np.sort(rng.random((6, k), dtype=np.float32), 1)
    db = np.sort(rng.random((6, k), dtype=np.float32), 1)
    ia = rng.permutation(10 * k)[: 6 * k].reshape(6, k).astype(np.int32)
    ib = (ia + 10 * k).astype(np.int32)
    jd, ji = jtopk.merge_topk(jnp.asarray(da), jnp.asarray(ia), jnp.asarray(db),
                              jnp.asarray(ib), k=k)
    td, ti = ttopk.merge_topk(torch.from_numpy(da), torch.from_numpy(ia), torch.from_numpy(db),
                              torch.from_numpy(ib), k=k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
