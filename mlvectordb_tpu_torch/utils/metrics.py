"""Prometheus-format metrics: the port's copy of ``mlvectordb_tpu/utils/metrics.py``
(framework-free), with the same metric names, and one of the port's own:
``vectordb_span_cpu_avg_ms``, each phase's mean thread CPU time (``SpanRecorder``'s
``<name>.cpu`` aggregates, which are not phases).

Scrape-ready counters/gauges assembled from the engine's existing telemetry: query
counters + latencies (QueryStats), span aggregates (SpanRecorder), storage gauges, and
device memory.  Text format per the Prometheus exposition spec; no client library
needed.
"""

from __future__ import annotations

from typing import List

from .tracing import CPU_SUFFIX


def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def render_metrics(query_processor, recorder=None) -> str:
    lines: List[str] = []

    def metric(name, mtype, help_text, samples):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            if labels:
                lab = ",".join(f'{k}="{_esc(str(v))}"' for k, v in labels.items())
                lines.append(f"{name}{{{lab}}} {value}")
            else:
                lines.append(f"{name} {value}")

    stats = query_processor.get_statistics()
    metric(
        "vectordb_queries_total", "counter", "Queries executed by type",
        [({"type": t}, c) for t, c in stats["queries_by_type"].items()] or [({}, 0)],
    )
    metric(
        "vectordb_query_latency_avg_ms", "gauge", "Average query latency by type (ms)",
        [({"type": t}, round(v, 4)) for t, v in stats["avg_latency_ms_by_type"].items()]
        or [({}, 0)],
    )

    info = query_processor.get_storage_info()
    metric("vectordb_vectors_total", "gauge", "Live vectors across namespaces",
           [({}, info["total_vectors"])])
    metric("vectordb_namespaces", "gauge", "Namespace count", [({}, info["namespace_count"])])
    metric("vectordb_storage_bytes", "gauge", "Device bytes allocated to vector storage",
           [({}, info["storage_size_bytes"])])
    metric(
        "vectordb_namespace_vectors", "gauge", "Live vectors per namespace",
        [({"namespace": n}, c) for n, c in info["vectors_per_namespace"].items()] or [({}, 0)],
    )
    dm = info.get("device_memory") or {}
    if dm.get("bytes_in_use") is not None:
        metric("vectordb_device_memory_bytes", "gauge", "Device memory usage",
               [({"kind": "in_use"}, dm["bytes_in_use"]),
                ({"kind": "limit"}, dm.get("bytes_limit") or 0),
                ({"kind": "peak"}, dm.get("peak_bytes_in_use") or 0)])

    if recorder is not None:
        summary = recorder.summary()
        # a phase's thread CPU time is its own gauge, never a phase of its own
        cpu = {n[: -len(CPU_SUFFIX)]: a for n, a in summary.items() if n.endswith(CPU_SUFFIX)}
        summary = {n: a for n, a in summary.items() if not n.endswith(CPU_SUFFIX)}
        metric(
            "vectordb_span_total", "counter", "Engine phase executions",
            [({"phase": n}, a["count"]) for n, a in summary.items()] or [({}, 0)],
        )
        metric(
            "vectordb_span_avg_ms", "gauge", "Engine phase average duration (ms)",
            [({"phase": n}, round(a["avg_ms"], 4)) for n, a in summary.items()] or [({}, 0)],
        )
        if cpu:
            metric(
                "vectordb_span_cpu_avg_ms", "gauge",
                "Engine phase average thread CPU time (ms)",
                [({"phase": n}, round(a["avg_ms"], 4)) for n, a in cpu.items()],
            )

    return "\n".join(lines) + "\n"
