"""Build and bind the CUDA kernels in csrc/ (plain C interface + ctypes).

`load()` compiles each csrc/*.cu with nvcc for sm_90a into its own shared
library under knoxdb_tpu_torch/_build/ on first use, one nvcc process per
source, all started together, each library named by a hash of its
sources and the flags (an edited source builds anew), and binds the C
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
from types import SimpleNamespace

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
_L = ctypes.c_longlong
_SIGNATURES = {
    "knox_fused_tree_agg": [_PP, _IP, _I, _PP, _PP, _PP, _IP, _I, _IP, _PP,
                            _PP, _I, _P, _P, _P, _I, _I, _P],
    "knox_fused_range_sum_masked": [_P, _I, _L, _L, _P, _P, _P, _P, _P, _P,
                                    _P, _I, _I, _P],
    "knox_range_mask_count": [_P, _I, _L, _L, _P, _P, _P, _P, _P, _P, _I, _I,
                              _P],
    "knox_masked_plane_popcounts": [_P, _I, _L, _L, _P, _P, _P, _I, _I, _P],
    "knox_group_sums": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I,
                        _I, _I, _I, _P],
    "knox_group_max_clusters": [_I, _I, _I, _I],
    "knox_group_chunk_partials": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _P],
    "knox_tile_bitonic_sort": [_P, _P, _P, _P, _I, _I, _P],
}


_lib = None
build_info: dict = {}     # seconds, library paths and nvcc's -Xptxas -v logs


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _build() -> list[Path]:
    """Compile every csrc/*.cu that has no library yet, in parallel."""
    headers = sorted(SRC_DIR.glob("*.cuh"))
    jobs, libs = [], []
    t0 = time.perf_counter()
    for src in sorted(SRC_DIR.glob("*.cu")):
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in [src, *headers]:
            h.update(s.name.encode())
            h.update(s.read_bytes())
        so = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
        libs.append(so)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            jobs.append((so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    failed = []
    for so, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{so.name}: nvcc exit {proc.returncode}\n{out}")
        else:
            so.with_suffix(".log").write_text(out.strip())
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    # each library's nvcc log is kept beside it, so a cached build reports
    # ptxas' lines too
    logs = [f"[{so.name}]\n" + (so.with_suffix(".log").read_text()
                                if so.with_suffix(".log").exists() else "")
            for so in libs]
    build_info.update(seconds=time.perf_counter() - t0,
                      library=", ".join(str(s) for s in libs),
                      log="\n".join(logs))
    return libs


def load() -> SimpleNamespace:
    """The bound C entry points of every built library, by name, built on
    first use."""
    global _lib
    if _lib is None:
        kernels = SimpleNamespace()
        for so in _build():
            lib = ctypes.CDLL(str(so))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name, None)
                if fn is None:
                    continue
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(kernels, name, fn)
        missing = [n for n in _SIGNATURES if not hasattr(kernels, n)]
        if missing:
            raise RuntimeError(f"kernel entry points not found: {missing}")
        _lib = kernels
    return _lib
