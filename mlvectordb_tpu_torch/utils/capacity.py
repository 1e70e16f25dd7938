"""Capacity planning: the counterpart of ``mlvectordb_tpu/utils/capacity.py``.

How much device memory a namespace of N vectors of dim D takes in the port, and how many
cards it needs, before any data moves.  The port's bytes differ from the JAX package's
where its store differs: a mirror of the rows' own type (an f32 mirror of an f32 store, a
bf16 mirror of a bf16 store) is the row tensor itself, so it adds nothing (ROADMAP §C).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import DEFAULT_CONFIG, EngineConfig

# device memory per card (bytes), for planning without the card; a present CUDA device
# reports its own (torch.cuda.get_device_properties(0).total_memory)
HBM_BYTES = {
    "h100": 80 * 1024**3,   # NVIDIA H100 80GB (SXM5 / PCIe)
}
DEFAULT_PART = "h100"


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    n_vectors: int
    dim: int
    dim_padded: int
    dtype: str
    bytes_per_vector: int
    data_bytes: int          # padded rows and the sweep arrays
    overhead_bytes: int      # masks + norms + per-row certificate vectors + phase-1 output
    total_bytes: int
    hbm_per_chip: int
    fits_single_chip: bool
    min_shards: int          # cards needed on the shard axis at the memory budget


def _sweep_bytes_per_dim(config: EngineConfig) -> int:
    """Bytes per element the sweep adds beside the rows, as NamespaceStore keeps them."""
    if config.sweep_dtype is None:
        return 0
    if config.sweep_dtype == "int8":
        return 1 + (1 if config.sweep_resid else 0)    # z1 codes, and z2
    if config.sweep_dtype == config.dtype:
        return 0                                      # the mirror is the rows themselves
    # a bf16 mirror of f32 rows, with the int8 residual codes
    return 2 + (1 if config.sweep_resid else 0)


def plan_capacity(
    n_vectors: int,
    dim: int,
    config: EngineConfig = DEFAULT_CONFIG,
    hbm_per_chip: Optional[int] = None,
    hbm_budget_fraction: float = 0.7,
) -> CapacityPlan:
    """Estimate device memory for a namespace and the card count it needs."""
    if hbm_per_chip is None:
        hbm_per_chip = _detect_hbm()
    dpad = config.pad_dim(dim)
    cap = config.round_capacity(n_vectors)
    per_dim = (2 if config.dtype == "bfloat16" else 4) + _sweep_bytes_per_dim(config)
    data = cap * dpad * per_dim
    # valid (1 B) + sq_norms (4 B) + certificate vectors (<= 12 B) + the phase-1 window
    # mins [cap/r1, B ~ 256] f32
    overhead = cap * 17 + (cap // 32) * 256 * 4
    total = data + overhead
    budget = int(hbm_per_chip * hbm_budget_fraction)
    return CapacityPlan(
        n_vectors=n_vectors,
        dim=dim,
        dim_padded=dpad,
        dtype=config.dtype,
        bytes_per_vector=dpad * per_dim,
        data_bytes=data,
        overhead_bytes=overhead,
        total_bytes=total,
        hbm_per_chip=hbm_per_chip,
        fits_single_chip=total <= budget,
        min_shards=max(1, -(-total // budget)),
    )


def _detect_hbm() -> int:
    """The present card's memory, else the table's entry for the card the port targets."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return HBM_BYTES[DEFAULT_PART]
