"""Backend dispatch: the counterpart of ``mlvectordb_tpu/ops/backend.py``.

Both backends share one signature and produce identical (exact) results:
    backend(q, data, valid, sq_norms, *, k, metric, db_tile, live_prefix) -> (dist, idx)

``use_pallas`` selects the fused path (ops/fused_knn.exact_knn_fused): its window-min
kernels run as CUDA kernels on CUDA tensors and as their plain torch versions on CPU
tensors, so the selection and rescan code runs on both.  ``use_pallas=False`` selects
the tiled scan.  There is no silent fallback between the two: a kernel that cannot
build or launch raises.
"""

from __future__ import annotations

from ..config import EngineConfig
from .fused_knn import exact_knn_fused
from .topk import exact_knn


def _scan_backend(q, data, valid, sq_norms, *, k, metric, db_tile, live_prefix=None,
                  report_tier=False):
    d, i = exact_knn(q, data, valid, sq_norms, k=k, metric=metric, db_tile=db_tile)
    if report_tier:
        return d, i, -1  # no certificate ran: the scan IS the exact path
    return d, i


def _fused_backend(q, data, valid, sq_norms, *, k, metric, db_tile, live_prefix=None,
                   report_tier=False):
    d, i = exact_knn_fused(
        q, data, valid, sq_norms, k=k, metric=metric, db_tile=db_tile, live_prefix=live_prefix,
    )
    if report_tier:
        return d, i, -1  # row-major margin kernel: no certificate
    return d, i


def knn_backend(config: EngineConfig):
    return _fused_backend if config.use_pallas else _scan_backend
