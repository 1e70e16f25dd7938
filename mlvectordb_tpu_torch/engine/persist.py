"""Snapshot persistence: the counterpart of ``mlvectordb_tpu/engine/persist.py``.

A snapshot is the per-namespace device->host copy of the live rows with their id table
and metadata: one ``.npz`` of f32 values and one ``.json`` (name, dim, ids, metadata) per
namespace, and a ``manifest.json`` (format "mlvectordb-tpu-snapshot", version 1, the
engine config).  The format is the JAX package's, byte for byte in its fields, so a
deployment moves between the two packages in either direction.  A bf16 store writes its
stored (bf16-rounded) rows as f32, as the JAX store does.

A namespace with an IVF index also writes ``<base>.ivf.npz`` (its centroids) and
``<base>.ivf.json`` (its layout: every id's cluster slots and the build parameters), and
its manifest entry says ``"ivf": true``; loading rebuilds the same index around the
restored rows without retraining.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import List, Optional

import numpy as np

from ..config import DEFAULT_CONFIG, EngineConfig
from ..store.storage import StorageEngine

_MANIFEST = "manifest.json"
_FORMAT = "mlvectordb-tpu-snapshot"


def _ns_file(i: int) -> str:
    return f"namespace_{i:05d}"


def resolve_snapshot_dir(path) -> Optional[str]:
    """``path`` or ``path + ".old"`` if either holds a complete snapshot, else None.

    Checkpoint swaps are rename(ckpt, old); rename(tmp, ckpt): a crash between the two
    renames leaves only the ``.old`` directory, and recovery falls back to it rather than
    losing everything its pruned WAL segments covered."""
    if not path:
        return None
    if os.path.isfile(os.path.join(path, _MANIFEST)):
        return path
    old = path + ".old"
    if os.path.isfile(os.path.join(old, _MANIFEST)):
        return old
    return None


def save_storage(storage: StorageEngine, path: str) -> List[str]:
    """Write every namespace of ``storage`` under ``path``; returns the names written."""
    os.makedirs(path, exist_ok=True)
    names = storage.list_namespaces()
    manifest = {
        "format": _FORMAT,
        "version": 1,
        # captured for restore-time validation (a dtype change is legal: values are
        # stored f32; it only changes the device storage precision)
        "engine_config": dataclasses.asdict(storage.config),
        "namespaces": [],
    }
    for i, name in enumerate(names):
        ns = storage.namespace(name)
        if ns is None:
            continue
        snap = ns.snapshot_arrays()
        base = _ns_file(i)
        # uncompressed: f32 embeddings are near-incompressible
        np.savez(os.path.join(path, base + ".npz"), values=snap["values"])
        with open(os.path.join(path, base + ".json"), "w") as f:
            json.dump({"name": snap["name"], "dim": snap["dim"], "ids": snap["ids"],
                       "metadata": snap["metadata"]}, f)
        entry = {"name": name, "file": base, "count": len(snap["ids"])}
        # a trained index is minutes of k-means at scale: its centroids and layout are
        # saved, so a load restores the same approximate answers without retraining
        if ns.ivf is not None:
            isnap = ns.ivf.snapshot_arrays()
            np.savez(os.path.join(path, base + ".ivf.npz"), centroids=isnap.pop("centroids"))
            with open(os.path.join(path, base + ".ivf.json"), "w") as f:
                json.dump(isnap, f)
            entry["ivf"] = True
        manifest["namespaces"].append(entry)
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return names


def load_storage(
    path: str,
    config: EngineConfig = DEFAULT_CONFIG,
    storage: Optional[StorageEngine] = None,
    *,
    device="cuda",
) -> StorageEngine:
    """Restore a snapshot directory into a new engine on ``device``, or into ``storage``
    (an empty engine, whose own device and namespace factory then apply)."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != _FORMAT:
        raise ValueError(f"not a snapshot directory: {path}")
    saved_cfg = manifest.get("engine_config") or {}
    if saved_cfg.get("dtype") and saved_cfg["dtype"] != config.dtype:
        logging.getLogger(__name__).warning(
            "snapshot was written with dtype=%s, loading into dtype=%s (values are stored "
            "f32; this only changes device storage precision)", saved_cfg["dtype"], config.dtype)
    if storage is None:
        storage = StorageEngine(config, device=device)
    elif storage.list_namespaces():
        raise ValueError("load_storage target engine must be empty")
    for entry in manifest["namespaces"]:
        base = entry["file"]
        with np.load(os.path.join(path, base + ".npz")) as z:
            values = z["values"]
        with open(os.path.join(path, base + ".json")) as f:
            meta = json.load(f)
        ns = storage.namespace(meta["name"], create=True).load_snapshot({
            "name": meta["name"], "dim": meta["dim"], "ids": meta["ids"], "values": values,
            "metadata": meta["metadata"]})
        if entry.get("ivf"):
            from ..store.ivf import IVFIndex

            with np.load(os.path.join(path, base + ".ivf.npz")) as z:
                centroids = z["centroids"]
            with open(os.path.join(path, base + ".ivf.json")) as f:
                isnap = json.load(f)
            isnap["centroids"] = centroids
            ns.ivf = IVFIndex.from_snapshot(ns, isnap)
    return storage
