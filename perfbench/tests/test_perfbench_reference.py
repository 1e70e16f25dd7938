"""The float64 reference against a brute-force NumPy answer on tiny data."""

import numpy as np
import pytest
import torch

from perfbench import reference


def _brute(x, q, k, metric, keep=None):
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    rows = np.arange(x.shape[0]) if keep is None else np.flatnonzero(keep)
    out_i, out_d = [], []
    for qi in q64:
        d = []
        for r in rows:
            if metric == "l2":
                d.append(((x64[r] - qi) ** 2).sum())
            elif metric == "ip":
                d.append(1 - x64[r] @ qi)
            else:
                d.append(1 - x64[r] @ qi / np.sqrt((x64[r] @ x64[r]) * (qi @ qi)))
        d = np.array(d)
        order = np.lexsort((rows, d))[:k]
        out_i.append(rows[order])
        out_d.append(d[order])
    return np.array(out_i), np.array(out_d)


def _chunks(x, size):
    for lo in range(0, x.shape[0], size):
        yield lo, torch.from_numpy(x[lo:lo + size])


@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
@pytest.mark.parametrize("filtered", [False, True])
def test_exact_topk_matches_brute_force(metric, filtered):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    q = rng.standard_normal((7, 24)).astype(np.float32)
    keep = None
    if filtered:
        cols = {"id": np.arange(300)}
        keep = reference.filter_mask(cols, {"id": {"$gte": 290}}, 300)
        assert keep.sum() == 10
    got_i, got_d = reference.exact_topk(_chunks(x, 64), torch.from_numpy(q), 5, metric, keep,
                                        query_block=3)
    want_i, want_d = _brute(x, q, 5, metric, keep)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-12, atol=1e-12)


def test_fewer_admitted_rows_than_k():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((50, 8)).astype(np.float32)
    q = rng.standard_normal((2, 8)).astype(np.float32)
    keep = reference.filter_mask({"id": np.arange(50)}, {"id": {"$in": [3, 40]}}, 50)
    got_i, _ = reference.exact_topk(_chunks(x, 16), torch.from_numpy(q), 10, "l2", keep)
    assert got_i.shape == (2, 2) and set(got_i[0]) == {3, 40}


def test_filter_ops():
    cols = {"id": np.arange(10)}
    f = reference.filter_mask
    assert f(cols, {"id": 4}, 10).tolist() == [i == 4 for i in range(10)]
    assert f(cols, {"id": {"$gt": 7}}, 10).sum() == 2
    assert f(cols, {"id": {"$lte": 2, "$ne": 1}}, 10).sum() == 2
    assert f(cols, {"id": {"$nin": [0, 1]}}, 10).sum() == 8
    assert f(cols, {"other": 1}, 10).sum() == 0
    assert f(cols, None, 10).all()


def test_pair_distance_matches_matrix_form():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 3, 16)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    for metric in ("l2", "ip", "cosine"):
        pair = reference.pair_distance64(x, q, metric)
        for i in range(4):
            full = reference.distance64(x[i], q[i:i + 1], metric)[0]
            torch.testing.assert_close(pair[i], full, rtol=1e-12, atol=1e-12)
