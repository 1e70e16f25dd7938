"""Auxiliary subsystems: tracing spans."""

from .tracing import trace_span

__all__ = ["trace_span"]
