"""Auxiliary subsystems: tracing and profiling spans, health checks, metrics, capacity."""

from .tracing import PROFILER, RECORDER, trace_span
from .health import deep_health, probe_device

__all__ = ["PROFILER", "RECORDER", "trace_span", "deep_health", "probe_device"]
