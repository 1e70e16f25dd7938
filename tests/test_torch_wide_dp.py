"""Wide embeddings (Dp = 1536 and 3072) through the port's QueryProcessor against the JAX
package's, on the CPU: a bf16 store with its same-dtype sweep, an f32 store with an int8
mirror (two streams and one), and an f32 store with a bf16 mirror, light on gaussian rows
and heavy after the flip on a clustered namespace.  On the card these widths run kernel
B1/B3 with its query tile streamed through the block (tests/test_torch_gpu.py); here the
port's wrappers run their plain versions and the JAX engine its Pallas kernels in
interpret mode, told it runs on a TPU so that it picks its certified sweep.

Each batch is held to: the same id sets (gaussian rows) or the same sorted distances
within 1e-4 relative plus the f32 cancellation of l2's expansion (clustered rows, whose
near ties the two sides may order differently); the same tier and the same light/heavy
mode; one copy each way on both sides at tier 0, and on an escalation JAX's one program
against the port's counted escalation copies.  Before and after deletes.  Inputs are
made with numpy from a seed.  Last, ROADMAP C15: where a bf16 store's sweep escalates to
the exact scan, the port's answer is the exact one over the stored rows and JAX's is not.
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

N, B, K = 8192, 8, 10
CONFIGS = {"bf16_store": dict(dtype="bfloat16", sweep_dtype="bfloat16"),
           "int8": dict(sweep_dtype="int8"),
           "int8_one_stream": dict(sweep_dtype="int8", sweep_resid=False),
           "bf16_mirror": dict(sweep_dtype="bfloat16")}
# one metric per case, so that the file covers the three
METRIC = {"bf16_store": "cosine", "int8": "l2", "int8_one_stream": "ip", "bf16_mirror": "l2"}


@pytest.fixture
def jax_on_tpu(monkeypatch):
    monkeypatch.setattr(jax_backend, "jax",
                        types.SimpleNamespace(default_backend=lambda: "tpu"))


def _settle(jqp):
    """Wait for the JAX engine's background heavy warm to switch the mode."""
    import time

    deadline = time.time() + 300
    while time.time() < deadline:
        with jqp._cert_lock:
            if not jqp._heavy_warms:
                return
        time.sleep(0.05)
    raise AssertionError("the JAX heavy warm did not finish")


def _load_both(cfg, x, ids, ns):
    # one query bucket: the JAX engine's flip to heavy warms the heavy program at every
    # bucket, each run in interpret mode
    cfg = dict(cfg, query_buckets=(B,))
    jqp = JaxQueryProcessor(config=JaxConfig(**cfg))
    tqp = QueryProcessor(EngineConfig(**cfg), device="cpu")
    for qp in (jqp, tqp):
        qp.bulk_load(x, ns, ids=ids)
    return jqp, tqp


def _moved(qp, before):
    return (qp.transfer_counts["h2d"] - before["h2d"], qp.transfer_counts["d2h"] - before["d2h"])


def _batch(jqp, tqp, queries, metric, ns, scale=None):
    """One batch through both engines; asserts the results, the tier, the mode and the
    transfers (see the module's note).  Returns the port's results and its tier."""
    jx, tx, t0 = dict(jqp.transfer_counts), dict(tqp.transfer_counts), tqp.cert_tier_counts(ns)
    jr = jqp.find_similar_batch([JaxDTO(v) for v in queries], K, ns, metric)
    tr = tqp.find_similar_batch([VectorDTO(v) for v in queries], K, ns, metric)
    _settle(jqp)
    for i, (a, b) in enumerate(zip(jr, tr)):
        assert len(a) == len(b) == K
        if scale is None:
            assert {r["id"] for r in a} == {r["id"] for r in b}, i
        atol = 1e-4 if scale is None else 1e-4 + 16 * 2.0 ** -24 * scale[i]
        np.testing.assert_allclose(sorted(r["score"] for r in b),
                                   sorted(r["score"] for r in a), rtol=1e-4, atol=atol)
    assert tqp.cert_tier_counts(ns) == jqp.cert_tier_counts(ns)
    assert tqp._cert_mode == jqp._cert_mode
    tier = [t for t, c in tqp.cert_tier_counts(ns).items() if c != t0.get(t, 0)]
    assert len(tier) == 1
    assert _moved(jqp, jx) == (1, 1)
    moved = _moved(tqp, tx)
    assert moved == (1, 1) if tier[0] in ("fast", "light_fast") else (
        moved[0] == 1 and moved[1] >= 2), (tier, moved)
    return tr, tier[0]


def _gaussian(seed, dim):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, dim), dtype=np.float32)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, N)]
    return rng, x, ids, rng.standard_normal((B, dim), dtype=np.float32)


def _gaussian_batches(jqp, tqp, rng, ids, queries, metric, ns, before=1):
    """``before`` batches before 100 deletes (among them the first query's best), one
    after."""
    for i in range(before):
        tr, _ = _batch(jqp, tqp, queries + np.float32(i * 1e-4), metric, ns)
    gone = [ids[i] for i in rng.choice(N, 99, replace=False)] + [tr[0][0]["id"]]
    assert sorted(map(str, jqp.delete(gone, ns))) == sorted(map(str, tqp.delete(gone, ns)))
    tr, _ = _batch(jqp, tqp, queries + np.float32(1e-3), metric, ns)
    assert not {r["id"] for rs in tr for r in rs} & set(gone)


@pytest.mark.parametrize("dim", [1536, 3072])
@pytest.mark.parametrize("config", ["bf16_store", "int8", "int8_one_stream"])
def test_gaussian_engine_at_wide_dp_matches_jax(jax_on_tpu, config, dim):
    """8,192 gaussian rows, 8 queries at k = 10, before and after 100 deletes: the same
    sets, tiers, modes and transfers as the JAX engine's."""
    rng, x, ids, queries = _gaussian(dim + len(config), dim)
    jqp, tqp = _load_both(CONFIGS[config], x, ids, "ns")
    _gaussian_batches(jqp, tqp, rng, ids, queries, METRIC[config], "ns")


@pytest.mark.parametrize("dim", [1536, 3072])
def test_bf16_mirror_at_wide_dp_matches_jax(jax_on_tpu, dim):
    """A bf16 mirror: the gaussian batches as above, with a second one before the deletes
    (light where its band certifies the corpus; at Dp = 3072 it does not, and the first
    batch flips the namespace to heavy, which serves the second), then in the same
    engines a clustered
    namespace (8 centres x 0.05, noise 1e-3), whose first batch escalates on the light
    program and flips it to heavy; the next batch runs the heavy program; after 100
    deletes the masked variant, which has its mode of its own, escalates and flips in turn,
    and the batch after it runs heavy."""
    rng, x, ids, queries = _gaussian(dim + 11, dim)
    jqp, tqp = _load_both(CONFIGS["bf16_mirror"], x, ids, "ns")
    _gaussian_batches(jqp, tqp, rng, ids, queries, "l2", "ns", before=2)
    centres = rng.standard_normal((8, dim)).astype(np.float32) * 0.05
    xc = (centres[rng.integers(0, 8, N)]
          + rng.standard_normal((N, dim)).astype(np.float32) * 1e-3).astype(np.float32)
    qc = (centres[rng.integers(0, 8, B)]
          + rng.standard_normal((B, dim)).astype(np.float32) * 1e-3).astype(np.float32)
    ids = [uuid.UUID(int=int(v)) for v in rng.integers(1, 2**62, N)]
    for qp in (jqp, tqp):
        qp.bulk_load(xc, "c", ids=ids)
    scale = (qc * qc).sum(-1) + (xc * xc).sum(-1).max()
    modes = len(tqp._cert_mode)
    _, first = _batch(jqp, tqp, qc, "l2", "c", scale)
    assert first == "light_exact_scan" and ("c", "l2", False) in tqp._cert_mode
    _, second = _batch(jqp, tqp, qc + np.float32(1e-4), "l2", "c", scale)
    assert not second.startswith("light_")
    gone = [ids[i] for i in rng.choice(N, 100, replace=False)]
    assert sorted(map(str, jqp.delete(gone, "c"))) == sorted(map(str, tqp.delete(gone, "c")))
    _, third = _batch(jqp, tqp, qc + np.float32(2e-4), "l2", "c", scale)
    assert third == "light_exact_scan" and len(tqp._cert_mode) == modes + 2
    tr, fourth = _batch(jqp, tqp, qc + np.float32(3e-4), "l2", "c", scale)
    assert not fourth.startswith("light_")
    assert not {r["id"] for rs in tr for r in rs} & set(gone)


def test_c15_bf16_store_scan_is_exact_over_the_stored_rows(jax_on_tpu):
    """ROADMAP C15, an intended divergence: a bf16 store's same-dtype sweep escalated to the
    exact scan.  The JAX package's scan ranks bf16(q) against the stored rows with the
    written rows' norms, so its set and scores are off the exact answer over the rows it
    stores (the answer its own tiers 0 and 1 give: their rescan scores the f32 query
    against the stored rows); the port's scan scores them as the rescan does.  On a
    clustered 8,192 x 1536 namespace (8 centres x 0.05, noise 1e-3) both escalate; the
    port returns the float64 oracle's rows over the stored bf16 rows with their distances
    within the f32 cancellation of l2's expansion, JAX neither."""
    dim = 1536
    rng = np.random.default_rng(15)
    centres = rng.standard_normal((8, dim)).astype(np.float32) * 0.05
    x = (centres[rng.integers(0, 8, N)]
         + rng.standard_normal((N, dim)).astype(np.float32) * 1e-3).astype(np.float32)
    q = (centres[rng.integers(0, 8, B)]
         + rng.standard_normal((B, dim)).astype(np.float32) * 1e-3).astype(np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(N)]
    jqp, tqp = _load_both(CONFIGS["bf16_store"], x, ids, "c")
    jr = jqp.find_similar_batch([JaxDTO(v) for v in q], K, "c", "l2")
    tr = tqp.find_similar_batch([VectorDTO(v) for v in q], K, "c", "l2")
    assert jqp.cert_tier_counts("c") == tqp.cert_tier_counts("c") == {"exact_scan": 1}
    rows = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    d = ((q.astype(np.float64)[:, None, :] - rows[None]) ** 2).sum(-1)
    want = np.sort(d, 1)[:, :K]
    tol = 16 * 2.0 ** -24 * ((q * q).sum(-1) + (rows * rows).sum(-1).max())[:, None]

    def errors(res):
        """(max |score - oracle|, max |oracle distance of the returned rows - oracle|)."""
        got = np.sort(np.array([[r["score"] for r in rs] for rs in res]), 1)
        ex = np.sort([[d[b, r["id"].int - 1] for r in rs] for b, rs in enumerate(res)], 1)
        return (np.abs(got - want) / tol).max(), (np.abs(ex - want) / tol).max()

    assert max(errors(tr)) <= 1.0
    assert min(errors(jr)) > 1.0
