"""Tracing spans: the counterpart of ``trace_span`` in ``mlvectordb_tpu/utils/tracing.py``.

A span is a ``torch.profiler.record_function`` range, so engine phases line up with
kernel launches when a ``torch.profiler`` trace is captured.  The attributes are
accepted so call sites read like their JAX counterparts; the span keeps only the name.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def trace_span(name: str, **attrs):
    with torch.profiler.record_function(name):
        yield
