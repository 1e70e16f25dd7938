"""Backend dispatch: the counterpart of ``mlvectordb_tpu/ops/backend.py``.

Both backends share one signature and produce identical (exact) results:
    backend(q, data, valid, sq_norms, *, k, metric, db_tile, live_prefix) -> (dist, idx)

``use_pallas`` selects the fused paths.  With a sweep ``mirror`` (the store keeps a bf16,
int8 or f32 one under ``sweep_dtype``) that is the certified sweep
(ops/fused_knn_t.exact_knn_t, kernels B1/B3 and B2); without one, the row-major window-min path (ops/fused_knn,
kernels B4 and B5).  Their kernels run as CUDA kernels on CUDA tensors and as their plain
torch versions on CPU tensors, so the selection and rescan code runs on both.
``use_pallas=False`` selects the tiled scan.  There is no silent fallback between them: a
kernel that cannot build or launch raises.

``report_tier`` adds the certificate tier that served the batch (-1: no certificate ran).
Both fused paths prove each query under ``certify_exact`` (the row-major one since
ROADMAP C20) and neither under ``certify_exact=False``.  ``sweep_defer`` returns the
device-side ``fused_knn_t.SweepResult`` of either fused path, so the caller can bring the
tier-1 result, its proof and the float64 settle's flags (ROADMAP C18) down in one copy.
``n_live`` is the caller's batch before its zero padding: phase 1 computes the live query
columns alone on both fused paths, and the row-major one returns the live rows alone.
"""

from __future__ import annotations

from ..config import EngineConfig
from .fused_knn import exact_knn_fused
from .fused_knn_t import exact_knn_t
from .topk import exact_knn


def _scan_backend(q, data, valid, sq_norms, *, k, metric, db_tile, live_prefix=None,
                  report_tier=False, **_sweep):
    d, i = exact_knn(q, data, valid, sq_norms, k=k, metric=metric, db_tile=db_tile)
    if report_tier:
        return d, i, -1  # no certificate ran: the scan IS the exact path
    return d, i


def _make_fused_backend(certify: bool):
    def fused_backend(q, data, valid, sq_norms, *, k, metric, db_tile, live_prefix=None,
                      report_tier=False, mirror=None, sweep_err=None, sweep_resid=None,
                      sweep_rscale=None, sweep_err1=None, sweep_rscale2=None,
                      sweep_light=False, sweep_prep=None, sweep_defer=False, n_live=None):
        if mirror is not None:
            # the certified sweep: phase 1 reads the mirror, the rescan the rows (f32, or
            # a bf16 store's, which are then its mirror too)
            return exact_knn_t(
                q, mirror, data, valid, sq_norms, k=k, metric=metric,
                live_prefix=live_prefix, sweep_err=sweep_err, resid=sweep_resid,
                rscale=sweep_rscale, err1=sweep_err1, rscale2=sweep_rscale2, certify=certify,
                report_tier=report_tier, light=sweep_light, prep_cache=sweep_prep,
                defer=sweep_defer, n_live=n_live,
            )
        # the row-major path: its own per-query proof (ROADMAP C20) where ``certify``
        return exact_knn_fused(
            q, data, valid, sq_norms, k=k, metric=metric, db_tile=db_tile,
            live_prefix=live_prefix, n_live=n_live, certify=certify, prep_cache=sweep_prep,
            report_tier=report_tier, defer=sweep_defer,
        )

    # the name explain_query reports (the JAX package names its fused backend
    # "exact_knn_pallas")
    fused_backend.__name__ = "exact_knn_fused"
    return fused_backend


def knn_backend(config: EngineConfig):
    return _make_fused_backend(config.certify_exact) if config.use_pallas else _scan_backend
