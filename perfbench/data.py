"""Inputs made from the seed: rows, queries and metadata.

Rows and queries are i.i.d. N(0, 1) float32, drawn on the device by a
``torch.Generator`` in a few large calls and copied once to the host.  The same seed
gives the same values on the same kind of device; ``rows`` can be drawn again after the
window, bit for bit, for the reference.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

# rows drawn per generator call: a fixed size, so the stream of calls (and so the
# values) depends only on the seed, and a chunk fits beside the store
CHUNK_ROWS = 1 << 18


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (``tag``) of a run's inputs."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             *(ord(c) for c in tag)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def device_chunks(seed: int, tag: str, n: int, dim: int, device) -> Iterator[Tuple[int, torch.Tensor]]:
    """(first row, [m, dim] float32 on ``device``) for rows [0, n) of stream ``tag``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, tag))
    for lo in range(0, n, CHUNK_ROWS):
        m = min(CHUNK_ROWS, n - lo)
        yield lo, torch.randn((m, dim), generator=gen, device=device, dtype=torch.float32)


def host_array(seed: int, tag: str, n: int, dim: int, device) -> np.ndarray:
    """Rows [0, n) of stream ``tag`` as one host array (drawn on ``device``)."""
    out = np.empty((n, dim), np.float32)
    view = torch.from_numpy(out)
    for lo, chunk in device_chunks(seed, tag, n, dim, device):
        view[lo:lo + chunk.shape[0]].copy_(chunk)
        del chunk
    return out


def metadata(spec: Optional[Dict[str, str]], n: int) -> Tuple[Optional[List[dict]], Dict[str, np.ndarray]]:
    """The rows' metadata dicts (None where the configuration has none) and the same
    values as columns.  ``spec`` maps a field to its generator; ``"row"`` gives row i
    the value i (VectorDBBench's int64 ``id`` scalar field)."""
    if not spec:
        return None, {}
    cols = {}
    for field, kind in spec.items():
        if kind != "row":
            raise ValueError(f"unknown metadata generator {kind!r} for {field!r}")
        cols[field] = np.arange(n, dtype=np.int64)
    fields = list(cols)
    dicts = [dict(zip(fields, vals)) for vals in zip(*(cols[f].tolist() for f in fields))]
    return dicts, cols
