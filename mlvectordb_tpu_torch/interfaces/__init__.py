"""Contract layer: the vector protocol and DTO (the ported subset of the JAX package's)."""

from .vector import VectorDTO, VectorProtocol

__all__ = ["VectorDTO", "VectorProtocol"]
