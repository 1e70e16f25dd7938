"""Write-ahead log: the port's copy of ``mlvectordb_tpu/engine/wal.py`` (numpy and the
stdlib only; importing the JAX package's module would pull in JAX).  The record format is
unchanged, so each package replays the other's log.

Crash durability for the window between snapshots.

The reference has no persistence at all (SURVEY.md §5.4); snapshots (engine/persist.py)
give coarse checkpoints, but every write since the last snapshot dies with the process.
The WAL closes that gap: every mutation is appended (and flushed) to a segment file
BEFORE it is applied to the device store, and recovery = load the snapshot + replay the
segments.  Replay is idempotent — upserts are by-id overwrites and deletes of missing
ids are no-ops — so the rotate-during-save race needs no coordination beyond "rotate
under the write lock, then snapshot": records that land in the new segment during the
snapshot are simply re-applied on recovery with identical results.

Record format (binary, append-only, self-delimiting):
    [4-byte little-endian header length][JSON header][raw float32 payload]
The header carries op/namespace/ids/metadata/dim; vector payloads ride as raw f32 so a
million-row bulk load doesn't pay JSON float serialization.  A torn final record
(crash mid-append) is detected by length/CRC mismatch and discarded — everything
before it replays.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import uuid as uuid_mod
import zlib
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

_MAGIC = b"MLVW"
_SEG_PREFIX = "wal_"


class WriteAheadLog:
    """Append-only segmented mutation log.

    One active segment file; ``rotate()`` seals it and starts a fresh one (called under
    the engine's write lock right before a snapshot, after which sealed segments are
    deleted).  ``replay(dir)`` yields every intact record across segments in order.
    """

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        os.makedirs(path, exist_ok=True)
        existing = self._segments()
        self._seq = (int(existing[-1].split("_")[1].split(".")[0]) + 1) if existing else 0
        # per-segment byte ledger: total_bytes() is called on every logged mutation
        # (the WAL-only checkpoint trigger), so it must not stat the directory each
        # time (ADVICE r3) — sizes are tracked incrementally from append/prune
        self._seg_bytes: Dict[str, int] = {}
        for f in existing:
            full = os.path.join(path, f)
            try:
                self._seg_bytes[full] = os.path.getsize(full)
            except FileNotFoundError:
                pass
        self._fh = None
        self._open_segment()

    def _segments(self) -> List[str]:
        return sorted(
            f for f in os.listdir(self.path)
            if f.startswith(_SEG_PREFIX) and f.endswith(".log")
        )

    def _open_segment(self) -> None:
        name = os.path.join(self.path, f"{_SEG_PREFIX}{self._seq:08d}.log")
        self._fh = open(name, "ab")
        self._active = name
        self._seg_bytes.setdefault(name, 0)

    # ------------------------------------------------------------------ append

    def append(
        self,
        op: str,
        namespace: str,
        ids: Optional[Sequence[uuid_mod.UUID]] = None,
        values: Optional[np.ndarray] = None,
        metadatas: Optional[Sequence[Optional[Dict[str, Any]]]] = None,
        params: Optional[Dict[str, Any]] = None,
    ) -> None:
        """``params``: op arguments with no vector payload (index lifecycle ops like
        build_ivf/drop_ivf log their build parameters here and replay re-derives the
        index from the recovered store)."""
        payload = b""
        header: Dict[str, Any] = {"op": op, "ns": namespace}
        if ids is not None:
            header["ids"] = [str(i) for i in ids]
        if metadatas is not None:
            header["meta"] = metadatas
        if params is not None:
            header["params"] = params
        if values is not None:
            values = np.ascontiguousarray(values, np.float32)
            header["shape"] = list(values.shape)
            payload = values.tobytes()
        hbytes = json.dumps(header, default=str).encode()
        crc = zlib.crc32(hbytes) & 0xFFFFFFFF
        crc = zlib.crc32(payload, crc) & 0xFFFFFFFF
        rec = (
            _MAGIC
            + struct.pack("<II", len(hbytes), len(payload))
            + struct.pack("<I", crc)
            + hbytes
            + payload
        )
        with self._lock:
            self._fh.write(rec)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self._seg_bytes[self._active] = self._seg_bytes.get(self._active, 0) + len(rec)

    # ------------------------------------------------------------------ lifecycle

    def rotate(self) -> List[str]:
        """Seal the current segment and start a new one; returns sealed segment paths."""
        with self._lock:
            self._fh.close()
            sealed = [
                os.path.join(self.path, f)
                for f in self._segments()
                if int(f.split("_")[1].split(".")[0]) <= self._seq
            ]
            self._seq += 1
            self._open_segment()
            return sealed

    def prune(self, sealed: List[str]) -> None:
        """Delete sealed segments (call only after the covering snapshot is durable)."""
        for f in sealed:
            try:
                os.remove(f)
            except FileNotFoundError:
                pass
            self._seg_bytes.pop(f, None)

    def total_bytes(self) -> int:
        """Bytes currently held across all segments (drives WAL-only checkpointing).
        Served from the incremental ledger — no directory walk on the write path."""
        with self._lock:
            return sum(self._seg_bytes.values())

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # ------------------------------------------------------------------ recovery

    @staticmethod
    def replay(path: str) -> Iterator[Dict[str, Any]]:
        """Yield every intact record, oldest segment first.

        A torn/corrupt record stops replay ENTIRELY — not just its segment: records
        in later segments were written after the gap, and applying them without the
        gap's records would replay mutations out of order (a delete could land
        before the insert it tombstones).  A torn tail in the FINAL segment is the
        expected crash artifact; corruption in an earlier segment is logged as an
        error with the segments skipped (ADVICE r2)."""
        if not os.path.isdir(path):
            return
        segments = sorted(
            f for f in os.listdir(path) if f.startswith(_SEG_PREFIX) and f.endswith(".log")
        )
        for si, seg in enumerate(segments):
            full = os.path.join(path, seg)
            with open(full, "rb") as fh:
                data = fh.read()
            pos = 0
            torn = False
            while pos + 16 <= len(data):
                if data[pos : pos + 4] != _MAGIC:
                    torn = True
                    break
                hlen, plen = struct.unpack_from("<II", data, pos + 4)
                crc_stored = struct.unpack_from("<I", data, pos + 12)[0]
                end = pos + 16 + hlen + plen
                if end > len(data):
                    torn = True
                    break
                hbytes = data[pos + 16 : pos + 16 + hlen]
                payload = data[pos + 16 + hlen : end]
                crc = zlib.crc32(payload, zlib.crc32(hbytes) & 0xFFFFFFFF) & 0xFFFFFFFF
                if crc != crc_stored:
                    torn = True
                    break
                header = json.loads(hbytes)
                if payload:
                    header["values"] = np.frombuffer(payload, np.float32).reshape(
                        header["shape"]
                    )
                yield header
                pos = end
            if torn:
                _warn_torn(full, pos, len(data), segments[si + 1 :])
                return


def _warn_torn(path: str, pos: int, size: int, later_segments) -> None:
    import logging

    log = logging.getLogger(__name__)
    if later_segments:
        log.error(
            "WAL %s: torn/corrupt record at byte %d of %d in a NON-final segment — "
            "stopping replay here; %d later segment(s) NOT applied (%s) to preserve "
            "mutation order", path, pos, size, len(later_segments), later_segments,
        )
    else:
        log.warning(
            "WAL %s: torn/corrupt record at byte %d of %d — dropping the tail "
            "(expected after a crash mid-append)", path, pos, size
        )
