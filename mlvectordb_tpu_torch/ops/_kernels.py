"""Build and load the hand-written CUDA kernels of ``mlvectordb_tpu_torch/csrc``.

At first use, nvcc compiles every ``csrc/*.cu`` for ``sm_90a`` (one nvcc per source, all
started together) and links them into one shared library with a plain C interface under
``build/kernels/`` at the repository root; the file name carries a hash over all the
sources, so an edited source is rebuilt.  The library is loaded with ctypes.  A failed
build raises with nvcc's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
# the row_type argument of mlvdb_window_min and mlvdb_gather_score: f32 rows, or bf16
# rows (a dtype="bfloat16" store)
ROW_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _sources() -> list:
    """The translation units: one nvcc each."""
    return sorted(_CSRC.glob("*.cu"))


def _hashed_files() -> list:
    """Everything the library is built from: the sources and the shared headers."""
    return sorted([*_CSRC.glob("*.cu"), *_CSRC.glob("*.cuh")])


def library_path() -> Path:
    """The library's path for the sources as they stand (built or not)."""
    digest = hashlib.sha256()
    for src in _hashed_files():
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    # torch's own toolkit lookup: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, the default prefix
    from torch.utils.cpp_extension import CUDA_HOME

    path = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if CUDA_HOME is None or not path.exists():
        raise RuntimeError(f"nvcc not found (CUDA_HOME={CUDA_HOME}): cannot build the CUDA kernels")
    return str(path)


def _check(cmd, res) -> None:
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}\n{res.stderr}")


def build() -> Path:
    """Compile the kernels (when not yet built for these sources) and return the library."""
    sources = _sources()
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = BUILD_DIR / f"tmp.{os.getpid()}"
    work.mkdir(exist_ok=True)
    try:
        objs = [work / f"{src.stem}.o" for src in sources]
        cmds = [[nvcc, *_ARCH, "-Xcompiler", "-fPIC", "-c", "-o", str(o), str(src)]
                for src, o in zip(sources, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        for cmd, proc in zip(cmds, procs):
            out, err = proc.communicate()
            _check(cmd, subprocess.CompletedProcess(cmd, proc.returncode, out, err))
        tmp = work / lib.name
        cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        _check(cmd, subprocess.run(cmd, capture_output=True, text=True, check=False))
        os.replace(tmp, lib)  # atomic: another process never loads a partial file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's argument types declared."""
    lib = ctypes.CDLL(str(build()))
    lib.mlvdb_window_min.argtypes = [_P, _P, _P, _P, _LL, _P, _LL, _I, _I, _I, _I, _I, _I, _I,
                                     _P]
    lib.mlvdb_sweep_min.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _P]
    lib.mlvdb_sweep_route.argtypes = [_I, _I, _I, _I, _I]
    lib.mlvdb_gather_score.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.mlvdb_int8_mma_min.argtypes = [_P, _P, _P, _LL, _I, _I, _P]
    lib.mlvdb_int8_stream_sum.argtypes = [_P, _P, _LL, _I, _I, _P]
    for fn in (lib.mlvdb_window_min, lib.mlvdb_sweep_min, lib.mlvdb_sweep_route,
               lib.mlvdb_gather_score, lib.mlvdb_int8_mma_min, lib.mlvdb_int8_stream_sum):
        fn.restype = _I
    return lib
