"""mlvectordb_tpu_torch — the PyTorch + CUDA port of mlvectordb_tpu.

The default exact k-NN serving path (row-major f32 store, fused window-min kernels
hand-written in CUDA for Hopper, window selection and exact f32 rescan, hydration) runs
on a CUDA device; the same code runs on the CPU with the kernels' plain torch versions.
Every tensor lives on the ``torch.device`` the caller passes.  This package never imports
JAX.
"""

from .config import DEFAULT_CONFIG, EngineConfig, canonical_metric
from .interfaces import VectorDTO, VectorProtocol
from .store import DeviceState, NamespaceStore, StorageEngine, Vector
from .engine import QueryProcessor

__version__ = "0.1.0"

__all__ = [
    "EngineConfig",
    "DEFAULT_CONFIG",
    "canonical_metric",
    "Vector",
    "VectorDTO",
    "VectorProtocol",
    "DeviceState",
    "NamespaceStore",
    "StorageEngine",
    "QueryProcessor",
]
