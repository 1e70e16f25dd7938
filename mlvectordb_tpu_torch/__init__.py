"""mlvectordb_tpu_torch — the PyTorch + CUDA port of mlvectordb_tpu.

Two exact k-NN serving paths run on a CUDA device with kernels hand-written in CUDA for
Hopper: the default one (row-major f32 or bf16 store, fused window-min kernels, window
selection and exact f32 rescan, hydration) and, with a ``sweep_dtype``, the certified
sweep (a bf16 mirror with int8 residual codes, int8 codes in one or two streams, the f32
rows themselves, or a bf16 store's own rows, ranked by the sweep window-min kernel; the
gather-score rescan kernel; a per-query exactness certificate with escalation).  The same
code runs on the CPU with the kernels' plain torch versions.
Snapshots and the write-ahead log use the JAX package's formats, so a deployment moves
between the two packages in either direction; a cold namespace can be offloaded to host
memory.  An opt-in IVF index (``QueryProcessor.build_ivf``, searches with ``nprobe``)
gives approximate answers; the REST and gRPC server is ``mlvectordb_tpu_torch.api``,
which this module does not import.  Every tensor lives on the ``torch.device`` the caller passes; entry points default
to ``"cuda"``.  This package never imports JAX.
"""

from .config import DEFAULT_CONFIG, EngineConfig, canonical_metric
from .interfaces import (
    QueryProcessorProtocol,
    SearchIndexProtocol,
    SearchResultProtocol,
    StorageEngineProtocol,
    VectorDTO,
    VectorProtocol,
)
from .store import DeviceState, NamespaceStore, SearchIndex, SearchResult, StorageEngine, Vector
from .engine import QueryProcessor

__version__ = "0.1.0"

__all__ = [
    "EngineConfig",
    "DEFAULT_CONFIG",
    "canonical_metric",
    "Vector",
    "VectorDTO",
    "VectorProtocol",
    "SearchResultProtocol",
    "SearchIndexProtocol",
    "StorageEngineProtocol",
    "QueryProcessorProtocol",
    "DeviceState",
    "NamespaceStore",
    "StorageEngine",
    "SearchIndex",
    "SearchResult",
    "QueryProcessor",
]
