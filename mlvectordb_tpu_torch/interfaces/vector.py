"""Vector contract + DTO.

Capability parity: reference src/mlvectordb/interfaces/vector.py:7-23 (VectorProtocol with
id/values/metadata/shape, VectorDTO dataclass).  Extended with an optional client-supplied id
on the DTO so that upsert can actually overwrite by id — the reference always mints a fresh
uuid4 (reference: src/mlvectordb/implementations/vector.py:13), which makes its "upsert" a
pure insert (SURVEY.md §3.2).
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Any, Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np


@runtime_checkable
class VectorProtocol(Protocol):
    """What every stored vector exposes."""

    @property
    def id(self) -> uuid.UUID: ...

    @property
    def values(self) -> np.ndarray: ...

    @property
    def metadata(self) -> Dict[str, Any]: ...

    def shape(self) -> Tuple[int, ...]: ...


@dataclasses.dataclass
class VectorDTO:
    """Wire-format vector: raw values + metadata, with an optional explicit id.

    ``id=None`` means "mint a fresh uuid4 on insert"; a supplied id makes
    ``upsert_many`` a true overwrite-by-id.
    """

    values: Any
    metadata: Optional[Dict[str, Any]] = None
    id: Optional[uuid.UUID] = None
