"""Build and load the hand-written CUDA kernels of ``mlvectordb_tpu_torch/csrc``.

At first use, nvcc compiles ``csrc/window_min.cu`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/kernels/`` at the repository root; the file name
carries a hash of the source, so an edited source is rebuilt.  The library is loaded with
ctypes.  A failed build raises with nvcc's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "window_min.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _nvcc() -> str:
    # torch's own toolkit lookup: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, the default prefix
    from torch.utils.cpp_extension import CUDA_HOME

    path = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if CUDA_HOME is None or not path.exists():
        raise RuntimeError(f"nvcc not found (CUDA_HOME={CUDA_HOME}): cannot build the CUDA kernels")
    return str(path)


def build() -> Path:
    """Compile the kernels (when not yet built for this source) and return the library."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"window_min_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(_SOURCE),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, lib)  # atomic: another process never loads a partial file
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's argument types declared."""
    lib = ctypes.CDLL(str(build()))
    lib.mlvdb_window_min_fast.argtypes = [_P, _P, _P, _I, _P, _LL, _I, _I, _I, _I, _I, _P]
    lib.mlvdb_window_min_fast.restype = _I
    lib.mlvdb_window_min_masked.argtypes = [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P]
    lib.mlvdb_window_min_masked.restype = _I
    return lib
