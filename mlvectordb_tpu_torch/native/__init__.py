"""ctypes loader and wrapper for the native host runtime: the port's copy of
``mlvectordb_tpu/native/__init__.py`` (the stdlib and numpy only).

It builds the repository's unchanged sources ``native/metafilter.cpp`` (the columnar
metadata-filter evaluator, a plain C ABI loaded with ctypes) and ``native/hydrate.c``
(the ``_hydrate`` CPython extension: result-row construction) with
``make -C native BUILD=<repo>/build/native`` on first use, passing the running Python's
include directory and extension suffix on the make line (the Makefile would ask
``python3-config``, which a machine may lack).  Each target is made in a fresh directory
of its own and renamed into ``build/native/``, so processes building at once never load
a half-written library, and ``native/build/`` (the JAX package's) is never written.
These are host code, not device kernels: without a toolchain everything falls back to
the pure-Python paths, whose results are the same.
"""

from __future__ import annotations

import ctypes
import json
import logging
import os
import shutil
import subprocess
import sysconfig
import tempfile
import threading
from typing import Any, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
_EXT = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
_SO_NAME = "libmetafilter.so"
_HYDRATE_NAME = f"_hydrate{_EXT}"


def _built(name: str, source: str) -> Optional[str]:
    """The path of target ``name`` of native/Makefile in BUILD_DIR, made (or remade, when
    ``source`` is newer) on demand; None when it cannot be built."""
    out = os.path.join(BUILD_DIR, name)
    src = os.path.join(_NATIVE_DIR, source)
    if os.path.exists(out) and not (
            os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(out)):
        return out
    if not os.path.exists(src):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".make-", dir=BUILD_DIR)
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, f"BUILD={tmp}",
             f"PYINC=-I{sysconfig.get_paths()['include']}", f"EXT={_EXT}",
             os.path.join(tmp, name)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(os.path.join(tmp, name), out)
        return out
    except Exception as e:  # toolchain or headers missing
        detail = getattr(e, "stderr", b"") or b""
        logger.warning("native build of %s failed: %s %s", name, e, detail.decode()[-500:])
        return None
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------------ metafilter library

_lib = None
_lib_lock = threading.Lock()
_load_failed = False


def load() -> Optional[ctypes.CDLL]:
    """The metafilter library, building it on first use; None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        so = _built(_SO_NAME, "metafilter.cpp")
        if so is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:  # pragma: no cover
            logger.warning("native metafilter load failed: %s", e)
            _load_failed = True
            return None
        lib.mf_create.restype = ctypes.c_void_p
        lib.mf_create.argtypes = [ctypes.c_int64]
        lib.mf_destroy.argtypes = [ctypes.c_void_p]
        lib.mf_resize.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.mf_set.restype = ctypes.c_int
        lib.mf_set.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        lib.mf_clear.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.mf_set_many.restype = ctypes.c_int
        lib.mf_set_many.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ]
        lib.mf_eval.restype = ctypes.c_int64
        lib.mf_eval.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


# ------------------------------------------------------------------ _hydrate extension

_hydrate_mod = None
_hydrate_failed = False
_hydrate_lock = threading.Lock()


def hydrate_module():
    """The _hydrate CPython extension (native/hydrate.c), built on first use; None when
    it cannot be built or loaded (callers keep the pure-Python path)."""
    global _hydrate_mod, _hydrate_failed
    if _hydrate_mod is not None or _hydrate_failed:
        return _hydrate_mod
    with _hydrate_lock:
        if _hydrate_mod is not None or _hydrate_failed:
            return _hydrate_mod
        so = _built(_HYDRATE_NAME, "hydrate.c")
        if so is None:
            _hydrate_failed = True
            return None
        try:
            import importlib.util

            spec = importlib.util.spec_from_file_location("_hydrate", so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except Exception as e:  # pragma: no cover - ABI mismatch etc.
            logger.warning("native _hydrate load failed: %s", e)
            _hydrate_failed = True
            return None
        _hydrate_mod = mod
        return _hydrate_mod


class MetaColumns:
    """Slot-aligned columnar metadata mirror living in the native library.

    The store feeds it on upsert/delete/compact; the filter-mask cache evaluates filter
    specs against it in C++ instead of looping dicts in Python.  Canonical-JSON encoding
    (sort_keys) keeps complex-value equality consistent with Python dict equality.
    """

    def __init__(self, capacity: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native metafilter unavailable")
        self._lib = lib
        self._handle = lib.mf_create(capacity)
        self.capacity = capacity
        self._lock = threading.Lock()

    def __del__(self):
        h = getattr(self, "_handle", None)
        if h:
            self._lib.mf_destroy(h)
            self._handle = None

    def resize(self, new_capacity: int) -> None:
        with self._lock:
            self._lib.mf_resize(self._handle, new_capacity)
            self.capacity = new_capacity

    def set(self, slot: int, metadata: Optional[Dict[str, Any]]) -> bool:
        blob = json.dumps(metadata or {}, sort_keys=True, separators=(",", ":")).encode()
        with self._lock:
            return self._lib.mf_set(self._handle, slot, blob, len(blob)) == 0

    def set_many(self, slots, metadatas) -> bool:
        """Batch set: one native call for a whole upsert batch."""
        blobs = [
            json.dumps(m or {}, sort_keys=True, separators=(",", ":")).encode()
            for m in metadatas
        ]
        concat = b"".join(blobs)
        offsets = np.zeros(len(blobs) + 1, np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        slots_arr = np.asarray(slots, np.int64)
        with self._lock:
            rc = self._lib.mf_set_many(
                self._handle,
                slots_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                concat,
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(blobs),
            )
        return rc == 0

    def clear(self, slot: int) -> None:
        with self._lock:
            self._lib.mf_clear(self._handle, slot)

    def eval(self, spec: Dict[str, Any], capacity: Optional[int] = None) -> Optional[np.ndarray]:
        """[capacity] bool mask of slots whose metadata matches, or None if the spec
        could not be evaluated natively (caller falls back to Python)."""
        cap = capacity if capacity is not None else self.capacity
        blob = json.dumps(spec, sort_keys=True, separators=(",", ":")).encode()
        out = np.zeros(cap, np.uint8)
        with self._lock:
            n = self._lib.mf_eval(
                self._handle, blob, len(blob),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
            )
        if n < 0:
            return None
        return out.astype(bool)
