"""Tracing and profiling: the counterpart of ``mlvectordb_tpu/utils/tracing.py``.

Every engine phase (kernel dispatch, hydration, mask build, writes) runs under a span
that (a) feeds the in-process ring buffer ``RECORDER`` (per-name counts and times; the
metrics endpoint reads its summary) and (b), where a profiler records its thread, opens
a ``torch.profiler.record_function`` range, so engine phases line up with the kernel
launches of a trace that ``PROFILER`` captures.

Span names are the JAX package's, and the port adds the search call's cut into siblings
that follow one another: ``query.prepare`` (stacking, the result-cache key and lookup),
``knn_upload`` (the query's copy to the device), ``knn_kernel`` / ``knn_sharded`` /
``knn_ivf`` (host issuing of the search, up to the tensors ready for the copy back),
``knn_fetch`` (the one copy back: waiting for the device, the copy, retaking the
interpreter lock), ``knn_finish`` (escalation and the wider settle) and
``query.cache_store`` (packing the result-cache entry).  The certified sweep cuts its
``knn_kernel`` into ``sweep.phase1`` (the folded query, its error terms, kernel B1's
launch), ``sweep.rescan`` (the selection, kernel B2, the settle) and ``sweep.proof``.
Beside ``name``, ``start`` (wall seconds) and ``elapsed_ms``, each recorded span carries
``req`` (the id of the ``request`` call it ran in, or None), ``parent`` (the innermost
span open around it on its thread, or None), ``tid`` (the thread's native id, as a
profiler's Chrome trace names threads) and ``cpu_ms`` (the thread's CPU time over the
span).  ``summary()`` adds ``<name>.cpu``, the summed CPU time of each span name, to the
per-name wall aggregates.
"""

from __future__ import annotations

import functools
import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, List, Optional

import torch

CPU_SUFFIX = ".cpu"  # summary() key of a span name's summed thread CPU time
_NO_RANGE = nullcontext()


class SpanRecorder:
    """Lock-protected ring buffer of completed spans and per-name aggregates."""

    def __init__(self, max_spans: int = 2048):
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=max_spans)
        self._agg: Dict[str, Dict[str, float]] = {}
        self._cpu: Dict[str, Dict[str, float]] = {}

    def record(self, name: str, start: float, elapsed_s: float, attrs: Dict[str, Any],
               cpu_s: Optional[float] = None, req: Optional[int] = None,
               parent: Optional[str] = None, tid: Optional[int] = None):
        ms = elapsed_s * 1e3
        cpu_ms = None if cpu_s is None else cpu_s * 1e3
        with self._lock:
            self._spans.append({"name": name, "start": start, "elapsed_ms": ms, "req": req,
                                "parent": parent, "tid": tid, "cpu_ms": cpu_ms, **attrs})
            _add(self._agg, name, ms)
            if cpu_ms is not None:
                _add(self._cpu, name, cpu_ms)

    def recent(self, limit: int = 100) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._spans)[-limit:]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per span name: count, total_ms, max_ms, avg_ms of its wall; and under
        ``<name>.cpu`` the same of its thread CPU time."""
        with self._lock:
            aggs = list(self._agg.items())
            aggs += [(name + CPU_SUFFIX, a) for name, a in self._cpu.items()]
            return {name: {**a, "avg_ms": a["total_ms"] / a["count"] if a["count"] else 0.0}
                    for name, a in aggs}

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._agg.clear()
            self._cpu.clear()


def _add(agg: Dict[str, Dict[str, float]], name: str, ms: float) -> None:
    a = agg.setdefault(name, {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
    a["count"] += 1
    a["total_ms"] += ms
    a["max_ms"] = max(a["max_ms"], ms)


RECORDER = SpanRecorder()

_REQ_IDS = itertools.count(1)     # one process-wide counter: ``next`` is atomic
_local = threading.local()        # per thread: ``req`` and the stack of open span names


def request(fn):
    """Run ``fn`` as one request: the spans its thread records meanwhile carry a fresh
    ``req``.  A call made inside another request keeps the outer id."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if getattr(_local, "req", None) is not None:
            return fn(*args, **kwargs)
        _local.req = next(_REQ_IDS)
        try:
            return fn(*args, **kwargs)
        finally:
            _local.req = None
    return wrapper


@contextmanager
def trace_span(name: str, **attrs):
    """Host wall-clock span, recorded in ``RECORDER`` with its thread's CPU time, and a
    profiler range of the name where a profiler records this thread.  The clocks are read
    inside the range, so the recorded interval lies within the profiler's range of the
    same span.  Without a profiler no range is opened: opening and closing one are calls
    into torch's dispatcher, which give up the interpreter lock, and with several client
    threads each taking it back can wait a switch interval."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    parent = stack[-1] if stack else None
    stack.append(name)
    rng = (torch.profiler.record_function(name) if torch.autograd._profiler_enabled()
           else _NO_RANGE)
    try:
        with rng:
            start = time.time()
            t0 = time.perf_counter()
            c0 = time.thread_time_ns()
            try:
                yield
            finally:
                cpu_ns = time.thread_time_ns() - c0
                elapsed = time.perf_counter() - t0
                RECORDER.record(name, start, elapsed, attrs, cpu_s=cpu_ns * 1e-9,
                                req=getattr(_local, "req", None), parent=parent,
                                tid=threading.get_native_id())
    finally:
        stack.pop()


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
