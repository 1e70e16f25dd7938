"""Compute layer: distances, the tiled exact scan, and the fused window-min path.

  * ``topk.exact_knn`` — tiled scan with a carried top-k (small namespaces, reference);
  * ``fused_knn.exact_knn_fused`` — hand-written CUDA window-min kernels
    (``csrc/window_min.cu``) followed by window selection and an exact f32 rescan.
"""

from .distances import pairwise_distances, query_norms
from .fused_knn import exact_knn_fused
from .topk import exact_knn, merge_topk

__all__ = ["pairwise_distances", "query_norms", "exact_knn", "exact_knn_fused", "merge_topk"]
