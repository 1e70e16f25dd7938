"""State carried across from the JAX package.

``store_from_jax_snapshot`` builds a torch ``NamespaceStore`` from the dict that the JAX
``NamespaceStore.snapshot_arrays()`` returns (numpy values, string ids, metadata), through
``bulk_upsert`` as the JAX ``load_snapshot`` does; under ``sweep_dtype="bfloat16"`` that
builds the bf16 mirror and the residual arrays from the rows, and under
``dtype="bfloat16"`` the snapshot's f32 values round to bf16 on the device as the JAX
store rounds them (its norms taken from the f32 values, as there).  Data plays the role of
weights here: a namespace served by the JAX package can be served by this one with the
same ids.

``sweep_arrays_from_jax`` turns a JAX namespace's sweep arrays (numpy copies of its
window-major ``_data_t`` and ``_sweep_resid`` and its per-row vectors) into the port's
row-major ones, for a bf16, int8 or f32 mirror, so the two stores can be shown to hold the
same codes; for a bf16 store's same-dtype mirror the result equals the port's ``data``.

``ivf_from_jax`` carries a trained JAX ``IVFIndex`` across to a port store holding the same
ids: its centroids, every id's cluster slot and the spill copies, through the index's
snapshot payload (``snapshot_arrays`` -> ``IVFIndex.from_snapshot``), so both packages
search one layout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .config import EngineConfig
from .ops.fused_knn_t import R1MAX, SWEEP_TILE, WLANE
from .store.ivf import IVFIndex
from .store.namespace import NamespaceStore


def store_from_jax_snapshot(snap: Dict[str, Any], config: EngineConfig,
                            device="cuda") -> NamespaceStore:
    return NamespaceStore.from_snapshot(snap, config, device=device)


def rows_from_sweep_layout(arr_t: np.ndarray) -> np.ndarray:
    """Invert the JAX package's ``to_sweep_layout`` (unsharded): column
    t*4096 + r*128 + j of the window-major ``[Dp, cap]`` array holds store row
    (t*128 + j)*32 + r, so a reshape-transpose gives back the ``[cap, Dp]`` rows."""
    Dp, cap = arr_t.shape
    return arr_t.reshape(Dp, cap // SWEEP_TILE, R1MAX, WLANE).transpose(1, 3, 2, 0).reshape(
        cap, Dp)


def sweep_arrays_from_jax(data_t: np.ndarray, sweep_resid: Optional[np.ndarray] = None,
                          sweep_err=None, sweep_rscale=None, sweep_err1=None,
                          sweep_rscale2=None, *, device) -> Dict[str, Optional[torch.Tensor]]:
    """The port's row-major sweep arrays from a JAX namespace's: ``data_t`` is its
    window-major mirror (numpy: ml_dtypes bfloat16, int8 codes or f32 — for f32 the
    result equals the port's ``data``), ``sweep_resid`` its int8 codes in the same
    layout; the per-row vectors are in store-row order on both sides."""
    data_t = np.asarray(data_t)
    if data_t.dtype in (np.int8, np.float32):
        mirror = torch.from_numpy(np.ascontiguousarray(rows_from_sweep_layout(data_t)))
    else:   # bfloat16: numpy has no such type, so the bits travel as int16
        mirror = torch.from_numpy(np.ascontiguousarray(
            rows_from_sweep_layout(data_t.view(np.int16)))).view(torch.bfloat16)
    out = {"mirror": mirror.to(device)}
    out["sweep_resid"] = None if sweep_resid is None else torch.from_numpy(
        np.ascontiguousarray(rows_from_sweep_layout(np.asarray(sweep_resid, np.int8)))).to(device)
    for name, v in (("sweep_err", sweep_err), ("sweep_rscale", sweep_rscale),
                    ("sweep_err1", sweep_err1), ("sweep_rscale2", sweep_rscale2)):
        out[name] = None if v is None else torch.from_numpy(np.array(v, np.float32)).to(device)
    return out


def ivf_from_jax(jax_index, store: NamespaceStore) -> IVFIndex:
    """The port's index over ``store`` with ``jax_index``'s centroids and layout (the
    store must hold the ids the JAX index places; ids it lacks are dropped, as a snapshot
    load drops them).  The caller attaches it (``store.ivf = ...``)."""
    return IVFIndex.from_snapshot(store, jax_index.snapshot_arrays())
