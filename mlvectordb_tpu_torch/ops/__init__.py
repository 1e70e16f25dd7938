"""Compute layer: distances, the tiled exact scan, and the two fused paths.

  * ``topk.exact_knn`` — tiled scan with a carried top-k (small namespaces, reference);
  * ``fused_knn.exact_knn_fused`` — hand-written CUDA window-min kernels
    (``csrc/window_min.cu``) followed by window selection and an exact f32 rescan;
  * ``fused_knn_t.exact_knn_t`` — the certified sweep over a bf16, int8 or f32 mirror:
    the sweep window-min kernel (``csrc/sweep_min.cu``), selection, the gather-score
    rescan kernel
    (``csrc/gather_score.cu``) and the per-query exactness certificate.
"""

from .distances import pairwise_distances, query_norms
from .fused_knn import exact_knn_fused
from .fused_knn_t import exact_knn_t
from .topk import exact_knn, merge_topk

__all__ = ["pairwise_distances", "query_norms", "exact_knn", "exact_knn_fused", "exact_knn_t",
           "merge_topk"]
