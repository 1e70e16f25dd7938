"""The port's operations surface on the CPU, held to the JAX package's: explain_query,
get_statistics and warmup (their keys and values for the same store and calls), the
``storage=`` constructor, and the entry points' default device.

One intended divergence (ROADMAP §C): JAX's explain engages the fused sweep only where
``jax.default_backend() == "tpu"``; the port runs the same certified program on any
device (the kernels' plain versions on the CPU), so its ``fused_active`` is the config
and the capacity alone, and it names its fused backend ``exact_knn_fused`` where JAX's
is ``exact_knn_pallas``.  With the JAX package told it runs on a TPU every other key is
equal; without that, the keys that follow ``fused_active`` differ as recorded.
"""

import inspect
import types
import uuid

import jax
import numpy as np
import pytest
import torch

import mlvectordb_tpu_torch as port
from mlvectordb_tpu.config import EngineConfig as JaxConfig
from mlvectordb_tpu.engine.query_processor import QueryProcessor as JaxQueryProcessor
from mlvectordb_tpu.interfaces.vector import VectorDTO as JaxDTO
from mlvectordb_tpu.ops import backend as jax_backend
from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, StorageEngine, VectorDTO
from mlvectordb_tpu_torch.ops import fused_knn_t

SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128), use_pallas=False)
N, D = 5000, 48


def _pair(kw, n=N, deletes=0):
    """The same rows (and deletes) in a JAX and a port processor of one config."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((n, D), dtype=np.float32)
    ids = [uuid.UUID(int=i + 1) for i in range(n)]
    jqp, tqp = JaxQueryProcessor(config=JaxConfig(**kw)), QueryProcessor(EngineConfig(**kw),
                                                                         device="cpu")
    for qp in (jqp, tqp):
        qp.bulk_load(x, "ns", ids=ids, metadatas=[{"p": i % 2} for i in range(n)])
        if deletes:
            qp.delete(ids[:deletes], "ns")
    return jqp, tqp, rng.standard_normal((4, D), dtype=np.float32)


# the configs explained: (config, capacity-setting kwargs)
EXPLAIN = {
    "scan": SMALL,
    "row_major_fused": dict(initial_capacity=8192),
    "bf16_sweep": dict(sweep_dtype="bfloat16", initial_capacity=8192),
    "bf16_sweep_heavy_only": dict(sweep_dtype="bfloat16", initial_capacity=8192,
                                  adaptive_certify=False),
    "int8_sweep": dict(sweep_dtype="int8", initial_capacity=8192),
    "f32_sweep": dict(sweep_dtype="float32", initial_capacity=8192),
    "bf16_sweep_margin": dict(sweep_dtype="bfloat16", initial_capacity=8192,
                              certify_exact=False),
    "bf16_sweep_small_capacity": dict(sweep_dtype="bfloat16", initial_capacity=4096),
    "bf16_store_same_dtype": dict(dtype="bfloat16", sweep_dtype="bfloat16",
                                  initial_capacity=8192),
    "bf16_store_int8": dict(dtype="bfloat16", sweep_dtype="int8", initial_capacity=8192),
    "bf16_store_f32": dict(dtype="bfloat16", sweep_dtype="float32", initial_capacity=8192),
}


@pytest.mark.parametrize("name", list(EXPLAIN))
def test_explain_matches_jax_on_a_tpu(name):
    jqp, tqp, queries = _pair(EXPLAIN[name], n=3000)
    cases = [dict(top_k=10), dict(top_k=100, metric="cosine"),
             dict(top_k=5000, filter={"p": 1}), dict(top_k=3, namespace="missing")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        for kw in cases:
            want = jqp.explain_query(JaxDTO(queries[0]), **kw)
            got = tqp.explain_query(VectorDTO(queries[0]), **kw)
            assert got.keys() == want.keys()
            fused = want["backend"] == "exact_knn_pallas"
            assert got["backend"] == ("exact_knn_fused" if fused else "_scan_backend")
            assert {k: v for k, v in got.items() if k != "backend"} == {
                k: v for k, v in want.items() if k != "backend"}, kw


@pytest.mark.parametrize("name, key, jax_cpu, port_value", [
    ("int8_sweep", "certificate_dispatch", "exact-scan", "heavy"),
    ("f32_sweep", "certificate_dispatch", "exact-scan", "heavy"),
    ("bf16_sweep_margin", "exact", True, False),
    ("bf16_sweep_margin", "expected_recall", 1.0, None),
    ("bf16_sweep_margin", "certificate_dispatch", "exact-scan", "margin"),
])
def test_explain_fused_active_divergence_on_the_cpu(name, key, jax_cpu, port_value):
    """ROADMAP §C: on the CPU the JAX engine serves its scan, so its explain reports the
    fused sweep disengaged; the port's engages it there too, and says so."""
    jqp, tqp, queries = _pair(EXPLAIN[name], n=3000)
    want = jqp.explain_query(JaxDTO(queries[0]), 10, "ns")
    got = tqp.explain_query(VectorDTO(queries[0]), 10, "ns")
    assert (want[key], got[key]) == (jax_cpu, port_value)


def test_explain_reports_the_served_tiers_and_the_flip():
    _, tqp, queries = _pair(EXPLAIN["bf16_sweep"], n=6000)
    tqp.find_similar_batch([VectorDTO(q) for q in queries], 10, "ns")
    plan = tqp.explain_query(VectorDTO(queries[0]), 10, "ns")
    assert plan["certificate_tiers"] == tqp.cert_tier_counts("ns") == {"light_fast": 1}
    assert plan["certificate_dispatch"] == "light"
    tqp._cert_mode[("ns", "l2", False)] = "heavy"
    assert tqp.explain_query(VectorDTO(queries[0]), 10, "ns")["certificate_dispatch"] == "heavy"
    # the filtered variant keeps its own mode
    assert tqp.explain_query(VectorDTO(queries[0]), 10, "ns",
                             filter={"p": 0})["certificate_dispatch"] == "light"


def _calls(qp, make, queries):
    qp.find_similar_batch([make(q) for q in queries], 5, "ns")
    qp.find_similar_batch([make(q) for q in queries], 5, "ns")          # a cache hit
    qp.find_similar(make(queries[0]), 5, "ns", "cosine", filter={"p": 1})
    qp.range_search(make(queries[1]), 80.0, "ns")
    qp.similarity_search(make(queries[1]), 0.1, "ns")
    qp.query_by_metadata({"p": 0}, "ns", limit=3)
    qp.find_similar(make(queries[0]), 5, "missing")


def test_statistics_match_jax():
    jqp, tqp, queries = _pair(SMALL, n=300)
    _calls(jqp, JaxDTO, queries)
    _calls(tqp, VectorDTO, queries)
    want, got = jqp.get_statistics(), tqp.get_statistics()
    assert got.keys() == want.keys()
    assert got["queries_by_type"] == want["queries_by_type"] == {
        "knn": 2, "cache_hit": 1, "hybrid": 1, "range": 2, "metadata": 1}
    assert got["total_queries"] == want["total_queries"] == 7
    assert got["avg_latency_ms_by_type"].keys() == want["avg_latency_ms_by_type"].keys()
    assert got["stage_budget_ms"].keys() == want["stage_budget_ms"].keys() == {"device",
                                                                             "hydrate"}
    assert got["exactness"] == want["exactness"] == {"certify_exact": True,
                                                     "contract": "certified"}


def test_statistics_tiers_by_namespace_match_jax_on_a_tpu():
    """On a certified bf16 mirror the tiers each batch was served at, per namespace: the
    JAX engine told it runs on a TPU (its Pallas kernels in interpret mode) and the
    port's (the plain versions) report the same."""
    kw = dict(sweep_dtype="bfloat16", initial_capacity=8192, query_buckets=(8, 64))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backend, "jax", types.SimpleNamespace(default_backend=lambda: "tpu"))
        jqp, tqp, queries = _pair(kw, n=6000, deletes=20)
        for qp, make in ((jqp, JaxDTO), (tqp, VectorDTO)):
            qp.find_similar_batch([make(q) for q in queries], 10, "ns")
    want, got = jqp.get_statistics(), tqp.get_statistics()
    assert got["exactness"] == want["exactness"]
    assert got["exactness"]["tiers_by_namespace"] == {"ns": {"light_fast": 1}}
    cfg = EngineConfig(**dict(kw, certify_exact=False))
    assert QueryProcessor(cfg, device="cpu").get_statistics()["exactness"] == {
        "certify_exact": False, "contract": "margin"}


def test_warmup_matches_jax_and_changes_nothing():
    jqp, tqp, _ = _pair(SMALL, n=30)
    ns = tqp.storage.namespace("ns")
    version, capacity, hw = ns.version, ns.capacity, ns._high_water
    for qp in (jqp, tqp):
        # no tombstones: auto mode runs the fast live-prefix variant only
        assert qp.warmup("ns", ks=(3,), batches=(1, 16), metrics=("l2",)) == 2
        assert qp.warmup("ns", ks=(3,), batches=(1, 16), metrics=("l2",),
                         include_masked=True) == 4
        # batches in the same bucket run the same program: deduplicated
        assert qp.warmup("ns", ks=(3,), batches=(1, 4), metrics=("l2",)) == 1
        assert qp.warmup("missing") == 0 and qp.warmup("missing", detail=True) == (0, {})
    assert tqp.get_namespace_count("ns") == 30
    assert (ns.version, ns.capacity, ns._high_water) == (version, capacity, hw)
    want = jqp.warmup("ns", ks=(3, 100), batches=(1, 64), metrics=("l2", "ip"), detail=True,
                      include_masked=True)
    got = tqp.warmup("ns", ks=(3, 100), batches=(1, 64), metrics=("l2", "ip"), detail=True,
                     include_masked=True)
    assert got[0] == want[0] == len(got[1]) and got[1].keys() == want[1].keys()
    assert "b4_k8_l2_fast" in got[1] and all(isinstance(v, float) for v in got[1].values())
    # tombstones present: the serving path takes the masked variant, so auto warms it
    for qp in (jqp, tqp):
        qp.delete([qp.get_namespace_vectors("ns")[3].id], "ns")
        assert qp.warmup("ns", ks=(3,), batches=(1,), metrics=("l2",)) == 2


def test_warmup_runs_the_sweep_programs_and_files_their_prep(monkeypatch):
    """On a certified bf16 mirror warmup runs each program through the backend call the
    search makes (the sweep kernel's plain version here), in the light mode serving
    would dispatch, and files each program's prep in the snapshot's prep dict; the
    default run covers every bucket up to 512 at k 10 and 100, l2 and cosine."""
    jqp, tqp, queries = _pair(EXPLAIN["bf16_sweep"], n=6000, deletes=10)
    lights = []
    real = fused_knn_t.exact_knn_t

    def spy(*a, **kw):
        lights.append(kw["light"])
        return real(*a, **kw)

    monkeypatch.setattr(fused_knn_t, "exact_knn_t", spy)
    from mlvectordb_tpu_torch.ops import backend as port_backend
    monkeypatch.setattr(port_backend, "exact_knn_t", spy)
    count, report = tqp.warmup("ns", detail=True)
    want_count, want_report = jqp.warmup("ns", detail=True)
    assert (count, report.keys()) == (want_count, want_report.keys())
    assert count == 3 * 2 * 2 * 2 == len(lights) and all(lights)
    state = tqp.storage.namespace("ns").device_state()
    assert len(state.prep_cache) == 2 * 2     # (metric, variant): l2/cosine x fast/masked
    before = len(lights)
    res = tqp.find_similar_batch([VectorDTO(q) for q in queries], 10, "ns", "l2")
    assert len(lights) == before + 1 and len(state.prep_cache) == 4 and len(res[0]) == 10


def test_storage_keyword_and_device_check():
    engine = StorageEngine(EngineConfig(**SMALL), device="cpu")
    qp = QueryProcessor(EngineConfig(**SMALL), device="cpu", storage=engine)
    assert qp.storage is engine and qp.device == torch.device("cpu")
    with pytest.raises(ValueError, match="storage lives on"):
        QueryProcessor(EngineConfig(**SMALL), device="meta", storage=engine)
    with pytest.raises(ValueError, match="storage lives on"):
        QueryProcessor(EngineConfig(**SMALL), storage=engine)   # the default is the card


@pytest.mark.parametrize("fn", [
    port.QueryProcessor.__init__, port.QueryProcessor.load, port.StorageEngine.__init__,
    port.NamespaceStore.__init__, port.NamespaceStore.from_snapshot, port.SearchIndex.__init__,
    "engine.persist.load_storage", "compat.QueryProcessor.__init__",
    "convert.store_from_jax_snapshot", "utils.health.probe_device",
], ids=lambda f: f if isinstance(f, str) else f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    """Every entry point runs on the card unless the caller asks for the CPU."""
    if isinstance(fn, str):
        import importlib

        mod, _, attr = fn.rpartition(".")
        if mod.endswith(".QueryProcessor"):
            mod, attr = mod.rpartition(".")[0], "QueryProcessor.__init__"
        obj = importlib.import_module(f"mlvectordb_tpu_torch.{mod}")
        for part in attr.split("."):
            obj = getattr(obj, part)
        fn = obj
    assert inspect.signature(fn).parameters["device"].default == "cuda"
