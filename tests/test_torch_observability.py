"""The port's tracing spans, profiler, health checks, metrics and capacity planner
(mlvectordb_tpu_torch/utils/), on the CPU: the cases of tests/test_observability.py
without its REST ones, held to the JAX package's output for the same calls: the same span
names and counts, the same health and metrics keys and names, beside the port's own
spans (the search call's cut, ``PORT_SPANS``) and their request ids, parents, thread CPU
times and clock.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

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
from mlvectordb_tpu_torch.parallel import make_distributed_processor
from mlvectordb_tpu_torch.utils.tracing import (CPU_SUFFIX, PROFILER, RECORDER, SpanRecorder,
                                                trace_span)

SMALL = dict(initial_capacity=64, capacity_multiple=32, db_tile=128,
             query_buckets=(4, 16, 64), k_buckets=(8, 32, 128), use_pallas=False)
# the fused backends (their plain versions on the CPU), whose results have a finish step
FUSED = dict(SMALL, use_pallas=True)

# The port's spans beyond the JAX package's, each as often as ``_drive`` records it: two
# find_similar calls (both miss the result cache) and a range search; the scan backend
# (``use_pallas=False``) has no finish step, so no ``knn_finish``.
PORT_SPANS = {"query.prepare": 2, "knn_upload": 3, "knn_fetch": 3, "query.cache_store": 2}
# one exact find_similar_batch on a fused backend, in order
CALL_SPANS = ["query.prepare", "knn_upload", "knn_kernel", "knn_fetch", "knn_finish",
              "hydrate", "query.cache_store"]


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
    summary = RECORDER.summary()
    got = {n: a["count"] for n, a in summary.items() if not n.endswith(CPU_SUFFIX)}
    want = {n: a["count"] for n, a in JAX_RECORDER.summary().items()}
    # the JAX package's names with its counts, and beyond them the port's own alone
    assert {n: c for n, c in got.items() if n in want} == want
    assert {n: c for n, c in got.items() if n not in want} == PORT_SPANS
    assert {n[: -len(CPU_SUFFIX)]: a["count"] for n, a in summary.items()
            if n.endswith(CPU_SUFFIX)} == got
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
    ({"dtype": "bfloat16", "sweep_dtype": "int8"}, 2),      # two int8 streams of bf16 rows
    ({"dtype": "bfloat16", "sweep_dtype": "int8", "sweep_resid": False}, 1),
    ({"dtype": "bfloat16", "sweep_dtype": "float32"}, 4),   # an f32 mirror of its own
])
def test_capacity_plan_counts_the_ports_bytes(kw, port_extra_per_dim):
    """The port's bytes per vector against the JAX planner's: equal except where the
    port's mirror is the row tensor itself (an f32 mirror of f32 rows, a bf16 store's
    same-dtype mirror), where it counts nothing; the overhead is the same.  A bf16
    store's f32 mirror is a tensor of its own in both packages."""
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

    # the JAX package's lines in its order, and beyond them the port's own alone: its
    # spans as phases, and each phase's CPU time as its own gauge (never as a phase)
    phases = [n for n in RECORDER.summary() if not n.endswith(CPU_SUFFIX)]
    added = ([f'vectordb_span_total{{phase="{n}"}} {c}' for n, c in PORT_SPANS.items()]
             + [f'vectordb_span_avg_ms{{phase="{n}"}}' for n in PORT_SPANS]
             + ["# TYPE vectordb_span_cpu_avg_ms gauge"]
             + [f'vectordb_span_cpu_avg_ms{{phase="{n}"}}' for n in phases])
    assert [line for line in shape(mine) if line not in added] == shape(want)
    assert sorted(line for line in shape(mine) if line in added) == sorted(added)
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


# ------------------------------------------------------------ the search call's spans

def _corpus_qp(rng, **cfg):
    qp = QueryProcessor(EngineConfig(**dict(FUSED, **cfg)), device="cpu")
    qp.bulk_load(rng.standard_normal((50, 8)).astype(np.float32), "ns",
                 metadatas=[{"i": i} for i in range(50)])
    return qp


def _queries(rng, n=3):
    return [VectorDTO(rng.standard_normal(8).astype(np.float32)) for _ in range(n)]


def _call(qp, queries, **kw):
    """The spans one find_similar_batch records, in the order they ended."""
    RECORDER.clear()
    qp.find_similar_batch(queries, 3, "ns", **kw)
    return RECORDER.recent(1000)


def test_exact_call_records_each_span_once_under_one_request(rng):
    qp = _corpus_qp(rng)
    spans = _call(qp, _queries(rng))
    assert [s["name"] for s in spans] == CALL_SPANS
    assert len({s["req"] for s in spans}) == 1 and spans[0]["req"] is not None
    assert all(s["parent"] is None for s in spans)
    assert {s["tid"] for s in spans} == {threading.get_native_id()}
    nxt = _call(qp, _queries(rng))
    assert [s["name"] for s in nxt] == CALL_SPANS
    assert {s["req"] for s in nxt} == {nxt[0]["req"]} and nxt[0]["req"] != spans[0]["req"]


def test_call_without_a_result_cache_has_no_store_span(rng):
    spans = _call(_corpus_qp(rng, result_cache_size=0), _queries(rng))
    assert [s["name"] for s in spans] == CALL_SPANS[:-1]


def test_call_spans_follow_one_another_without_overlap(rng):
    """Each span ends before the next one starts, on the ring's clock."""
    qp = _corpus_qp(rng)
    for kw in ({}, {"filter": {"i": {"$lt": 20}}}):
        spans = _call(qp, _queries(rng), **kw)
        for a, b in zip(spans, spans[1:]):
            assert a["start"] + a["elapsed_ms"] * 1e-3 <= b["start"], (a, b)


def test_filtered_call_records_its_mask_under_the_same_request(rng):
    qp = _corpus_qp(rng)
    spans = _call(qp, _queries(rng), filter={"i": {"$lt": 20}})
    assert [s["name"] for s in spans] == CALL_SPANS[:1] + ["filter_mask"] + CALL_SPANS[1:]
    assert len({s["req"] for s in spans}) == 1


def test_parent_is_the_span_open_around_it(rng):
    qp = _corpus_qp(rng)
    RECORDER.clear()
    with trace_span("caller"):
        qp.find_similar_batch(_queries(rng), 3, "ns")
    *inner, outer = RECORDER.recent(1000)
    assert [s["name"] for s in inner] == CALL_SPANS
    assert outer["name"] == "caller" and outer["parent"] is None and outer["req"] is None
    assert all(s["parent"] == "caller" for s in inner)
    # outside a request a span has no id
    with trace_span("alone"):
        pass
    assert RECORDER.recent(1)[0]["req"] is None


def test_cache_hit_records_prepare_alone(rng):
    qp = _corpus_qp(rng)
    queries = _queries(rng)
    first = _call(qp, queries)
    hit = _call(qp, queries)
    assert [s["name"] for s in hit] == ["query.prepare"]
    assert hit[0]["req"] != first[0]["req"] and qp._result_cache_hits == 1


def test_cpu_time_is_a_summary_aggregate_never_a_recent_span(rng):
    qp = _corpus_qp(rng)
    spans = _call(qp, _queries(rng))
    summary = RECORDER.summary()
    assert not any(s["name"].endswith(CPU_SUFFIX) for s in spans)
    for s in spans:
        assert 0.0 <= s["cpu_ms"] <= s["elapsed_ms"] + 1.0
    for name in CALL_SPANS:
        cpu, wall = summary[name + CPU_SUFFIX], summary[name]
        assert cpu["count"] == wall["count"] == 1
        assert 0.0 <= cpu["total_ms"] <= wall["total_ms"] + 1.0


def test_sharded_search_records_upload_fetch_and_finish_once(rng):
    qp = make_distributed_processor(2, 2, EngineConfig(**SMALL),
                                    devices=[torch.device("cpu")] * 4)
    qp.upsert_many([VectorDTO(rng.standard_normal(8).astype(np.float32), {"i": i})
                    for i in range(40)], "ns")
    for kw in ({}, {"filter": {"i": {"$lt": 20}}}):
        spans = _call(qp, _queries(rng, 5), **kw)
        counts = {}
        for s in spans:
            counts[s["name"]] = counts.get(s["name"], 0) + 1
        assert counts["knn_upload"] == counts["knn_sharded"] == 1
        assert counts["knn_fetch"] == counts["knn_finish"] == 1
        top = [s["name"] for s in spans if s["parent"] is None]
        assert top[top.index("knn_upload"):top.index("hydrate")] == [
            "knn_upload", "knn_sharded", "knn_fetch", "knn_finish"]
        assert all(s["parent"] == "knn_sharded" for s in spans
                   if s["name"] == "knn_sharded.merge")


def test_ivf_search_records_upload_and_fetch_once(rng):
    qp = _corpus_qp(rng)
    qp.build_ivf("ns", n_clusters=4, n_iters=5, seed=0)
    spans = _call(qp, _queries(rng), nprobe=2)
    assert [s["name"] for s in spans] == ["query.prepare", "knn_upload", "knn_ivf",
                                          "knn_fetch", "hydrate", "query.cache_store"]


def test_span_lies_inside_the_profilers_range_after_the_marker_shift(tmp_path):
    """The ring's interval of a span, moved onto the Chrome trace's clock by the
    benchmark capture's one-marker shift, lies inside the trace's range of the same name
    within 50 us.  The shift is late by at most the marker's own window (wall clock read
    to the capture's start), so a capture whose marker took 50 us or more (a process's
    first, cold one) is taken again."""
    from perfbench.capture import _MARK, Capture

    for _ in range(5):
        RECORDER.clear()
        cap = Capture()
        cap.start()
        for _ in range(3):
            with trace_span("clock.probe"):
                torch.ones(256).cumsum(0)
        cap.stop()
        if cap.t0_ns - cap.mark_wall_ns < 50_000:
            break
    assert cap.t0_ns - cap.mark_wall_ns < 50_000
    path = str(tmp_path / "trace.json")
    cap._prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    mark = next(round(float(e["ts"]) * 1000) for e in events if e["name"] == _MARK)
    shift = mark - cap.mark_wall_ns
    ranges = sorted((round(float(e["ts"]) * 1000), round(float(e["ts"] + e["dur"]) * 1000))
                    for e in events if e["name"] == "clock.probe")
    spans = [s for s in RECORDER.recent() if s["name"] == "clock.probe"]
    assert len(ranges) == len(spans) == 3
    for (lo, hi), s in zip(ranges, spans):
        start = round(s["start"] * 1e9) + shift
        end = start + round(s["elapsed_ms"] * 1e6)
        assert lo - 50_000 <= start and end <= hi + 50_000, (lo, hi, start, end)


def test_span_opens_a_profiler_range_only_under_a_profiler(monkeypatch):
    """Without a profiler recording the thread a span makes no call into torch's
    dispatcher (each would give up the interpreter lock); under one it opens its range."""
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    RECORDER.clear()
    with trace_span("unprofiled"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace_span("profiled"):
            pass
    assert opened == ["profiled"]
    assert "profiled" in {e.name for e in prof.events()}
    assert [s["name"] for s in RECORDER.recent()] == ["unprofiled", "profiled"]
