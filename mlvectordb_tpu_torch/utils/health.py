"""Failure detection: the counterpart of ``mlvectordb_tpu/utils/health.py``.

A deep health check exercises the stack: the device (its count and names, and a tiny
computation on it, synchronised and checked), per-namespace invariants (host tables
against live counts) and whether the native metadata filter builds.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import torch


def probe_device(device="cuda") -> Dict[str, Any]:
    """Run a tiny computation on ``device`` and verify the result.  ``platform`` is
    "gpu" for a CUDA device, else the device's type."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    try:
        if dev.type == "cuda":
            count = torch.cuda.device_count()
            names = [torch.cuda.get_device_name(i) for i in range(min(count, 8))]
            platform = "gpu"
        else:
            count, names, platform = 1, [str(dev)], dev.type
        x = torch.arange(8.0, device=dev)
        got = float((x * 2.0).sum().cpu())   # the copy synchronises the device
        return {
            "ok": abs(got - 56.0) < 1e-6,
            "platform": platform,
            "device_count": count,
            "devices": names,
            "probe_ms": (time.perf_counter() - t0) * 1e3,
        }
    except Exception as e:  # device failure path
        return {"ok": False, "error": f"{type(e).__name__}: {e}",
                "probe_ms": (time.perf_counter() - t0) * 1e3}


def check_store_invariants(storage) -> Dict[str, Any]:
    """Host-side consistency: id maps against slot tables against live counts."""
    issues = []
    for name in storage.list_namespaces():
        ns = storage.namespace(name)
        if ns is None:
            continue
        live = ns.live_count
        mapped = sum(1 for s in ns._slot_ids if s is not None)
        if live != mapped:
            issues.append(
                f"namespace {name!r}: id_to_slot has {live} ids but {mapped} slots are mapped")
        for vid, slot in list(ns._id_to_slot.items())[:1000]:  # bounded sample
            if ns._slot_ids[slot] != vid:
                issues.append(f"namespace {name!r}: slot {slot} maps to wrong id")
                break
    return {"ok": not issues, "issues": issues}


def deep_health(query_processor) -> Dict[str, Any]:
    from .. import __version__
    from ..native import available as native_available

    device = probe_device(query_processor.device)
    store = check_store_invariants(query_processor.storage)
    try:
        native_ok = native_available()
    except Exception:  # pragma: no cover - loader failure
        native_ok = False
    healthy = device["ok"] and store["ok"]
    return {
        "status": "healthy" if healthy else "degraded",
        "version": __version__,
        "device": device,
        "store": store,
        "native_filter_engine": native_ok,
        "total_vectors": query_processor.storage.total_vectors,
        "namespaces": len(query_processor.storage.list_namespaces()),
    }
