"""The CUDA window-min kernels against their plain torch versions, on the card.

Marked ``gpu``: each test skips without CUDA (decided inside the fixture, never at
import).  Run on a machine with an H100, without the JAX test harness of
tests/conftest.py:  python -m pytest --noconftest tests/test_torch_gpu.py -q
Tolerance on live windows: |kernel - plain| <= 1e-5 * |plain| + 1e-3 (the same f32
arithmetic in another summation order); fully masked windows are exactly 3e38.
"""

import numpy as np
import pytest
import torch

from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.ops import fused_knn
from mlvectordb_tpu_torch.ops.distances import MASKED

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    dead = want == MASKED
    np.testing.assert_array_equal(got[dead], want[dead])
    err = np.abs(got[~dead] - want[~dead])
    assert (err <= 1e-5 * np.abs(want[~dead]) + 1e-3).all(), float(err.max())


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
    _close(got, fused_knn._window_mins_fast_ref(data, qt, qn, hw, **kw))

    valid = torch.from_numpy(rng.random(n) > 0.01).to(cuda)
    valid[-fused_knn.DB_TILE:] = False
    maskadd = torch.where(valid, 0.0, float(MASKED))
    bias = ((data * data).sum(-1) + maskadd if metric == "l2" else maskadd)[:, None].contiguous()
    got = fused_knn._window_mins_masked(data, qt, qn, bias, **kw)
    torch.cuda.synchronize()
    _close(got, fused_knn._window_mins_masked_ref(data, qt, qn, bias, **kw))


def test_kernel_rejects_bad_operands(cuda):
    data = torch.zeros((8192, 128), device=cuda)
    with pytest.raises(ValueError):
        fused_knn._window_mins_fast(data, torch.zeros((128, 6), device=cuda),
                                    torch.zeros((1, 6), device=cuda), 10,
                                    metric="l2", db_tile=4096, r1=8)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_engine_on_cuda_matches_cpu(cuda, metric):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((20000, 128), dtype=np.float32)
    q = [VectorDTO(v) for v in rng.standard_normal((16, 128), dtype=np.float32)]
    out = []
    for device in ("cpu", cuda):
        qp = QueryProcessor(EngineConfig(), device=device)
        ids = qp.bulk_load(x, "ns", ids=None if not out else out[0][0])
        before = fused_knn._window_mins_fast.launches
        res = qp.find_similar_batch(q, 10, "ns", metric)
        launched = fused_knn._window_mins_fast.launches - before
        qp.delete(ids[::50], "ns")
        res2 = qp.find_similar_batch(q, 10, "ns", metric)
        out.append((ids, res, res2, launched))
    (_, c1, c2, _), (_, g1, g2, launched) = out
    assert launched == 1
    for a, b in ((c1, g1), (c2, g2)):
        for ra, rb in zip(a, b):
            assert [r["id"] for r in ra] == [r["id"] for r in rb]
            np.testing.assert_allclose([r["score"] for r in ra], [r["score"] for r in rb],
                                       rtol=1e-4, atol=1e-4)
