"""Concrete Vector: id + float32 values + metadata.

Capability parity: reference src/mlvectordb/implementations/vector.py:10-42 (uuid4 id,
float32 coercion, metadata dict, shape, __eq__ over id+values+metadata).  Additions are the
README-advertised-but-unimplemented helpers (SURVEY.md §0.1): distance / similarity /
normalize / to_dict / from_dict, plus an optional explicit id so true upsert is possible
(the reference always mints uuid4 — vector.py:13 — making overwrite-by-id impossible).
"""

from __future__ import annotations

import uuid
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..config import canonical_metric


class Vector:
    """An immutable-ish vector record: uuid id, float32 ndarray, free-form metadata."""

    __slots__ = ("_id", "_values", "_metadata")

    def __init__(
        self,
        values,
        metadata: Optional[Dict[str, Any]] = None,
        id: Optional[uuid.UUID] = None,
    ):
        self._id = id if id is not None else uuid.uuid4()
        self._values = np.asarray(values, dtype=np.float32)
        if self._values.ndim != 1:
            self._values = self._values.reshape(-1)
        self._metadata = dict(metadata) if metadata else {}

    @property
    def id(self) -> uuid.UUID:
        return self._id

    @property
    def values(self) -> np.ndarray:
        return self._values

    @property
    def metadata(self) -> Dict[str, Any]:
        return self._metadata

    def shape(self) -> Tuple[int, ...]:
        return self._values.shape

    @property
    def dim(self) -> int:
        return int(self._values.shape[0])

    # --- README-advertised helpers (SURVEY.md §0.1) -------------------------------------

    def normalize(self) -> "Vector":
        n = float(np.linalg.norm(self._values))
        vals = self._values / n if n > 0 else self._values
        return Vector(vals, self._metadata, id=self._id)

    def distance(self, other: "Vector", metric: str = "l2") -> float:
        m = canonical_metric(metric)
        a, b = self._values, other._values
        if m == "l2":
            d = a - b
            return float(np.dot(d, d))
        if m == "ip":
            return float(1.0 - np.dot(a, b))
        # cosine distance = 1 - cosine similarity
        return 1.0 - self.similarity(other)

    def similarity(self, other: "Vector") -> float:
        a, b = self._values, other._values
        na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
        if na == 0.0 or nb == 0.0:
            return 0.0
        return float(np.dot(a, b) / (na * nb))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": str(self._id),
            "values": self._values.tolist(),
            "metadata": self._metadata,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Vector":
        vid = d.get("id")
        return cls(
            d["values"],
            d.get("metadata") or {},
            id=uuid.UUID(vid) if vid else None,
        )

    # --- equality: same semantics as the reference (vector.py:35-42) --------------------

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Vector):
            return NotImplemented
        return (
            self._id == other._id
            and np.array_equal(self._values, other._values)
            and self._metadata == other._metadata
        )

    def __hash__(self) -> int:
        return hash(self._id)

    def __repr__(self) -> str:
        return f"Vector(id={self._id}, dim={self._values.shape[0]}, metadata={self._metadata})"
