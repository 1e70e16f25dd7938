"""The certified sweep's spans and kernel counters, on the CPU: one sweep call records
``sweep.phase1``, ``sweep.rescan`` and ``sweep.proof`` once each, inside its
``knn_kernel`` and under the call's request id; the row-major path and the shape gate's
scan record none of them; ``QueryProcessor.kernel_counts()`` and
``get_statistics()["kernels"]`` report the kernels' counters, which the plain versions
leave at 0; and the guarded increment keeps every update of four threads.
"""

import sys
import threading

import numpy as np
import pytest

from mlvectordb_tpu_torch import EngineConfig, QueryProcessor, VectorDTO
from mlvectordb_tpu_torch.ops import fused_knn_t as T
from mlvectordb_tpu_torch.utils.tracing import RECORDER

SWEEP_SPANS = ["sweep.phase1", "sweep.rescan", "sweep.proof"]
CALL_SPANS = ["query.prepare", "knn_upload", "knn_kernel", "knn_fetch", "knn_finish",
              "hydrate", "query.cache_store"]
DIM = 16


def _processor(rows, **cfg):
    qp = QueryProcessor(EngineConfig(**cfg), device="cpu")
    qp.bulk_load(np.random.default_rng(rows).standard_normal((rows, DIM), dtype=np.float32),
                 "ns")
    return qp


@pytest.fixture(scope="module")
def sweep_qp():
    """A bf16 sweep store past the shape gate: capacity 16,384 (two sweep tiles or more)."""
    qp = _processor(9000, sweep_dtype="bfloat16")
    assert qp.storage.namespace("ns").capacity >= 2 * T.SWEEP_TILE
    return qp


def _call(qp, n=16):
    """The spans of one find_similar_batch of ``n`` fresh queries, in the order they ended."""
    qs = np.random.default_rng(n).standard_normal((n, DIM), dtype=np.float32)
    RECORDER.clear()
    qp.find_similar_batch([VectorDTO(q) for q in qs], 10, "ns")
    return RECORDER.recent(1000)


def test_sweep_call_records_each_phase_once_inside_knn_kernel(sweep_qp):
    spans = _call(sweep_qp)
    names = [s["name"] for s in spans]
    assert [n for n in names if n not in SWEEP_SPANS] == CALL_SPANS
    # the phases end in order, each once, before their knn_kernel ends
    assert names[names.index("knn_upload") + 1:names.index("knn_kernel") + 1] == (
        SWEEP_SPANS + ["knn_kernel"])
    kernel = spans[names.index("knn_kernel")]
    end = kernel["start"] + kernel["elapsed_ms"] * 1e-3
    phases = [s for s in spans if s["name"] in SWEEP_SPANS]
    assert all(s["parent"] == "knn_kernel" and s["req"] == kernel["req"] for s in phases)
    assert kernel["req"] is not None and kernel["parent"] is None
    for s in phases:
        assert kernel["start"] <= s["start"] and s["start"] + s["elapsed_ms"] * 1e-3 <= end
    for a, b in zip(phases, phases[1:]):
        assert a["start"] + a["elapsed_ms"] * 1e-3 <= b["start"], (a, b)
    assert sweep_qp.cert_tier_counts("ns").get("light_fast", 0) >= 1


@pytest.mark.parametrize("path", ["row_major", "scan_gated"])
def test_other_paths_record_no_sweep_span(path):
    # the default row-major store, and a sweep store below two sweep tiles, whose search
    # the shape gate sends to the tiled scan (tier "disengaged")
    qp = (_processor(9000) if path == "row_major"
          else _processor(300, sweep_dtype="bfloat16"))
    spans = _call(qp)
    assert [s["name"] for s in spans] == CALL_SPANS
    if path == "scan_gated":
        assert qp.cert_tier_counts("ns") == {"light_disengaged": 1}


def test_kernel_counts_and_statistics_report_the_counters(sweep_qp, monkeypatch):
    before = sweep_qp.kernel_counts()
    assert set(before) == {"sweep_min", "gather_score"}
    assert set(before["sweep_min"]) == {"launches", "light", "heavy", "topm", "int8", "f32",
                                        "bp", "cols", "zero_query"}
    assert set(before["gather_score"]) == {"launches", "bf16", "rows"}
    _call(sweep_qp)
    # the plain versions ran: nothing counted
    assert sweep_qp.kernel_counts() == before == sweep_qp.get_statistics()["kernels"]
    # the counters read are the kernels' attributes; light is launches less heavy
    for attr, n in (("launches", 7), ("launches_heavy", 2), ("launches_zero", 3),
                    ("cols", 900)):
        monkeypatch.setattr(T._window_mins_t, attr, n)
    monkeypatch.setattr(T._gather_score, "launches", 5)
    monkeypatch.setattr(T._gather_score, "rows", 5 * 512 * 32 * 32)
    got = sweep_qp.get_statistics()["kernels"]
    assert {k: got["sweep_min"][k] for k in ("launches", "light", "heavy", "zero_query",
                                             "cols")} == {
        "launches": 7, "light": 5, "heavy": 2, "zero_query": 3, "cols": 900}
    assert got["gather_score"]["rows"] == 5 * 512 * 32 * 32
    assert got == sweep_qp.kernel_counts() == T.kernel_counts()


@pytest.mark.parametrize("kernel,attr", [("sweep_min", "launches"), ("sweep_min", "cols"),
                                         ("gather_score", "launches"),
                                         ("gather_score", "rows")])
def test_guarded_increment_loses_no_update(monkeypatch, kernel, attr):
    """Four threads count at once, switching every microsecond: every update is kept."""
    fn, lock = ((T._window_mins_t, T._B1_LOCK) if kernel == "sweep_min"
                else (T._gather_score, T._B2_LOCK))
    monkeypatch.setattr(fn, attr, 0)
    threads, calls, step = 4, 5000, 3
    start = threading.Barrier(threads)

    def work():
        start.wait(timeout=30)
        for _ in range(calls):
            T._count(fn, lock, **{attr: step})

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers)
    assert getattr(fn, attr) == threads * calls * step
    name = {"launches": "launches", "cols": "cols", "rows": "rows"}[attr]
    assert T.kernel_counts()[kernel][name] == threads * calls * step
