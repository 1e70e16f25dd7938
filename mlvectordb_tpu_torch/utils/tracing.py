"""Tracing and profiling: the counterpart of ``mlvectordb_tpu/utils/tracing.py``.

Every engine phase (kernel dispatch, hydration, mask build, writes) runs under a span
that (a) feeds the in-process ring buffer ``RECORDER`` (per-name counts and times; the
metrics endpoint reads its summary) and (b) opens a ``torch.profiler.record_function``
range, so engine phases line up with the kernel launches of a trace that ``PROFILER``
captures.  Span names are the JAX package's.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch


class SpanRecorder:
    """Lock-protected ring buffer of completed spans and per-name aggregates."""

    def __init__(self, max_spans: int = 2048):
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=max_spans)
        self._agg: Dict[str, Dict[str, float]] = {}

    def record(self, name: str, start: float, elapsed_s: float, attrs: Dict[str, Any]):
        with self._lock:
            self._spans.append(
                {"name": name, "start": start, "elapsed_ms": elapsed_s * 1e3, **attrs})
            agg = self._agg.setdefault(name, {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
            agg["count"] += 1
            agg["total_ms"] += elapsed_s * 1e3
            agg["max_ms"] = max(agg["max_ms"], elapsed_s * 1e3)

    def recent(self, limit: int = 100) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._spans)[-limit:]

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {**a, "avg_ms": a["total_ms"] / a["count"] if a["count"] else 0.0}
                for name, a in self._agg.items()
            }

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._agg.clear()


RECORDER = SpanRecorder()


@contextmanager
def trace_span(name: str, **attrs):
    """Host wall-clock span, recorded in ``RECORDER``, and a profiler range of the name."""
    start = time.time()
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        RECORDER.record(name, start, time.perf_counter() - t0, attrs)


class DeviceProfiler:
    """On-demand ``torch.profiler`` capture (the host and, where a CUDA device is
    present, its kernels); ``stop`` writes a Chrome trace into the ``log_dir`` given to
    ``start`` and returns the file's path."""

    def __init__(self):
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._prof = None

    @property
    def active(self) -> bool:
        return self._dir is not None

    def start(self, log_dir: str) -> None:
        with self._lock:
            if self._dir is not None:
                raise RuntimeError(f"profiler already tracing to {self._dir}")
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            os.makedirs(log_dir, exist_ok=True)
            prof = torch.profiler.profile(activities=activities)
            prof.__enter__()
            self._prof, self._dir = prof, log_dir

    def stop(self) -> str:
        with self._lock:
            if self._dir is None:
                raise RuntimeError("profiler is not tracing")
            prof, d = self._prof, self._dir
            self._prof = self._dir = None
            prof.__exit__(None, None, None)
            path = os.path.join(d, f"trace_{os.getpid()}_{time.time_ns()}.json")
            prof.export_chrome_trace(path)
            return path


PROFILER = DeviceProfiler()
