"""Build and bind the CUDA kernels in csrc/ (plain C interface + ctypes).

`load()` compiles every csrc/*.cu with nvcc for sm_90a into one shared
library under knoxdb_tpu_torch/_build/ on first use, named by a hash of
the sources and flags (an edited source builds anew), and binds its C
entry points with ctypes. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load", "NVCC_FLAGS", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_IP = ctypes.POINTER(ctypes.c_int)
_I = ctypes.c_int
_SIGNATURES = {
    "knox_fused_tree_agg": [_PP, _IP, _I, _PP, _PP, _PP, _IP, _I, _IP, _PP,
                            _PP, _I, _P, _P, _P, _I, _I, _P],
    "knox_fused_range_sum_masked": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _P],
}

_lib = None
build_info: dict = {}     # seconds, library path and nvcc's -Xptxas -v log


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _build() -> Path:
    sources = sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    so = BUILD_DIR / f"libknox_scan_{h.hexdigest()[:16]}.so"
    build_info["library"] = str(so)
    if so.exists():
        build_info.update(seconds=0.0, log="(cached)")
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sources if s.suffix == ".cu")]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    build_info.update(seconds=time.perf_counter() - t0,
                      log=(r.stdout + r.stderr).strip())
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{build_info['log']}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
