"""The port's tracing spans, profiler, health checks, metrics and capacity planner
(mlvectordb_tpu_torch/utils/), on the CPU: the cases of tests/test_observability.py
without its REST ones, held to the JAX package's output for the same calls: the same span
names and counts, the same health and metrics keys and names.
"""

import json
import os

import numpy as np
import pytest

from mlvectordb_tpu.config import EngineConfig as JaxConfig
from mlvectordb_tpu.engine.query_processor import QueryProcessor as JaxQueryProcessor
from mlvectordb_tpu.interfaces.vector import VectorDTO as JaxDTO
from mlvectordb_tpu.utils import capacity as jax_capacity
from mlvectordb_tpu.utils.health import deep_health as jax_deep_health
from mlvectordb_tpu.utils.metrics import render_metrics as jax_render_metrics
from mlvectordb_tpu.utils.tracing import RECORDER as JAX_RECORDER
from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.utils.capacity import HBM_BYTES, plan_capacity
from mlvectordb_tpu_torch.utils.health import check_store_invariants, deep_health, probe_device
from mlvectordb_tpu_torch.utils.metrics import render_metrics
from mlvectordb_tpu_torch.utils.tracing import PROFILER, RECORDER, SpanRecorder, trace_span

SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128), use_pallas=False)


def test_span_recorder_aggregates():
    rec = SpanRecorder(max_spans=4)
    rec.record("x", 0.0, 0.010, {})
    rec.record("x", 0.0, 0.030, {})
    rec.record("y", 0.0, 0.005, {"k": 1})
    s = rec.summary()
    assert s["x"]["count"] == 2
    assert s["x"]["avg_ms"] == pytest.approx(20.0)
    assert s["x"]["max_ms"] == pytest.approx(30.0)
    assert rec.recent()[-1]["name"] == "y"
    assert rec.recent()[-1]["k"] == 1
    for _ in range(5):
        rec.record("z", 0.0, 0.001, {})
    assert len(rec.recent()) == 4 and rec.summary()["z"]["count"] == 5
    rec.clear()
    assert rec.summary() == {} and rec.recent() == []


def _drive(qp, make, rng):
    """The same calls on either package: upserts, a bulk load, two searches (one
    filtered), a range search, deletes (one empty)."""
    qp.upsert_many([make(rng.standard_normal(8).astype(np.float32), {"i": i})
                    for i in range(20)], "ns")
    qp.bulk_load(rng.standard_normal((10, 8)).astype(np.float32), "ns")
    qp.find_similar(make(rng.standard_normal(8).astype(np.float32)), 3, "ns")
    qp.find_similar(make(rng.standard_normal(8).astype(np.float32)), 3, "ns",
                    filter={"i": {"$lt": 5}})
    qp.range_search(make(rng.standard_normal(8).astype(np.float32)), 50.0, "ns")
    qp.delete([], "ns")
    qp.delete([qp.get_namespace_vectors("ns")[0].id], "ns")


def test_engine_emits_the_jax_spans(small_config):
    """The same calls record the same span names, each as often, in both packages."""
    RECORDER.clear()
    JAX_RECORDER.clear()
    _drive(JaxQueryProcessor(config=small_config), JaxDTO, np.random.default_rng(5))
    _drive(QueryProcessor(EngineConfig(**SMALL), device="cpu"), VectorDTO,
           np.random.default_rng(5))
    got = {n: a["count"] for n, a in RECORDER.summary().items()}
    want = {n: a["count"] for n, a in JAX_RECORDER.summary().items()}
    assert got == want
    for name in ("upsert", "bulk_load", "knn_kernel", "hydrate", "filter_mask", "delete"):
        assert name in got, f"missing span {name}; have {list(got)}"
    assert got["knn_kernel"] == 3
    span = next(s for s in RECORDER.recent() if s["name"] == "knn_kernel")
    assert span["namespace"] == "ns" and span["elapsed_ms"] >= 0.0


def test_probe_device_and_invariants(small_config, rng):
    p = probe_device("cpu")
    assert p["ok"] is True and p["platform"] == "cpu"
    assert p["device_count"] >= 1 and p["devices"] == ["cpu"]

    qp = QueryProcessor(EngineConfig(**SMALL), device="cpu")
    qp.upsert_many([VectorDTO(rng.standard_normal(4).astype(np.float32)) for _ in range(5)],
                   "ns")
    assert check_store_invariants(qp.storage)["ok"] is True
    report = deep_health(qp)
    assert report["status"] == "healthy" and report["total_vectors"] == 5
    assert report["device"]["platform"] == "cpu"     # the processor's device is probed
    # the same report keys as the JAX package's
    jqp = JaxQueryProcessor(config=small_config)
    jqp.upsert_many([JaxDTO(rng.standard_normal(4).astype(np.float32)) for _ in range(5)], "ns")
    want = jax_deep_health(jqp)
    assert report.keys() == want.keys() and report["device"].keys() == want["device"].keys()
    assert report["store"] == want["store"]

    # a corrupted invariant -> degraded
    qp.storage.namespace("ns")._slot_ids[0] = None
    assert check_store_invariants(qp.storage)["ok"] is False
    assert deep_health(qp)["status"] == "degraded"
    # a device that cannot run the probe reports its failure instead of raising
    bad = probe_device("meta")
    assert bad["ok"] is False


def test_capacity_planner():
    # SIFT-1M f32 on a 16 GiB card: trivially fits
    p = plan_capacity(1_000_000, 128, hbm_per_chip=16 * 1024**3)
    assert p.fits_single_chip and p.min_shards == 1
    assert p.dim_padded == 128 and p.bytes_per_vector == 512
    # padding is accounted (100-d pads to 128 lanes)
    assert plan_capacity(10_000, 100, hbm_per_chip=16 * 1024**3).dim_padded == 128
    # without a card the planner uses the H100's 80 GB
    assert plan_capacity(1000, 128).hbm_per_chip == HBM_BYTES["h100"] == 80 * 1024**3


@pytest.mark.parametrize("kw, port_extra_per_dim", [
    ({}, 0),
    ({"sweep_dtype": "bfloat16"}, 3),                       # bf16 mirror + int8 codes
    ({"sweep_dtype": "bfloat16", "sweep_resid": False}, 2),
    ({"sweep_dtype": "int8"}, 2),                           # two int8 streams
    ({"sweep_dtype": "float32"}, 0),                        # the mirror is the rows
    ({"dtype": "bfloat16"}, 0),
    ({"dtype": "bfloat16", "sweep_dtype": "bfloat16"}, 0),  # the same-dtype mirror too
])
def test_capacity_plan_counts_the_ports_bytes(kw, port_extra_per_dim):
    """The port's bytes per vector against the JAX planner's: equal except where the
    port's mirror is the row tensor itself (an f32 mirror of f32 rows, a bf16 store's
    same-dtype mirror), where it counts nothing; the overhead is the same."""
    n, dim, hbm = 100_000_000, 1536, 80 * 1024**3
    mine = plan_capacity(n, dim, EngineConfig(**kw), hbm_per_chip=hbm)
    jax = jax_capacity.plan_capacity(n, dim, JaxConfig(**kw), hbm_per_chip=hbm)
    rows = 2 if kw.get("dtype") == "bfloat16" else 4
    assert mine.bytes_per_vector == dim * (rows + port_extra_per_dim)
    same_type = kw.get("sweep_dtype") == kw.get("dtype", "float32")
    assert jax.bytes_per_vector - mine.bytes_per_vector == (dim * rows if same_type else 0)
    assert mine.overhead_bytes == jax.overhead_bytes
    assert mine.total_bytes == mine.data_bytes + mine.overhead_bytes


def test_capacity_plan_100m_1536_bf16_same_dtype_on_h100():
    """BASELINE.md's 100M x 1536 bf16 same-dtype plan, counted with the port's bytes (the
    mirror is the rows: 3,072 B a vector where JAX's plan counts 6,144) on 80 GB cards."""
    cfg = EngineConfig(dtype="bfloat16", sweep_dtype="bfloat16")
    p = plan_capacity(100_000_000, 1536, cfg, hbm_per_chip=HBM_BYTES["h100"])
    assert p.bytes_per_vector == 3072 and p.data_bytes == (1 << 27) * 3072
    assert not p.fits_single_chip
    budget = int(HBM_BYTES["h100"] * 0.7)
    assert p.min_shards == -(-p.total_bytes // budget) == 7


def test_metrics_match_jax_names(small_config):
    """The same processor state renders the same metric names, labels and counts as the
    JAX package's exposition; only measured latencies differ."""
    RECORDER.clear()
    JAX_RECORDER.clear()
    jqp = JaxQueryProcessor(config=small_config)
    tqp = QueryProcessor(EngineConfig(**SMALL), device="cpu")
    _drive(jqp, JaxDTO, np.random.default_rng(9))
    _drive(tqp, VectorDTO, np.random.default_rng(9))
    mine = render_metrics(tqp, RECORDER)
    want = jax_render_metrics(jqp, JAX_RECORDER)

    def shape(text):
        out = []
        for line in text.splitlines():
            if line.startswith("# HELP"):
                continue
            name = line.split("{")[0].split(" ")[0]
            if "latency" in name or "avg_ms" in name:
                line = line.rsplit(" ", 1)[0]   # a measured time
            out.append(line)
        return out

    assert shape(mine) == shape(want)
    for kind in ("knn", "hybrid", "range"):
        assert f'vectordb_queries_total{{type="{kind}"}} 1' in mine
    assert 'vectordb_namespace_vectors{namespace="ns"} 29' in mine
    assert "# TYPE vectordb_span_avg_ms gauge" in mine
    assert render_metrics(tqp).count("vectordb_span") == 0


def test_profiler_writes_a_chrome_trace_with_the_spans(rng, tmp_path):
    qp = QueryProcessor(EngineConfig(**SMALL), device="cpu")
    qp.bulk_load(rng.standard_normal((50, 8)).astype(np.float32), "ns")
    with pytest.raises(RuntimeError, match="not tracing"):
        PROFILER.stop()
    PROFILER.start(str(tmp_path / "prof"))
    assert PROFILER.active
    with pytest.raises(RuntimeError, match="already tracing"):
        PROFILER.start(str(tmp_path / "other"))
    with trace_span("outer_test_span"):
        qp.find_similar(VectorDTO(rng.standard_normal(8).astype(np.float32)), 3, "ns")
    path = PROFILER.stop()
    assert not PROFILER.active and os.path.dirname(path) == str(tmp_path / "prof")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"outer_test_span", "knn_kernel", "hydrate"} <= names
