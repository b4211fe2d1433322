"""ctypes bindings of the native host kernels (carried over from
knoxdb_tpu/utils/native.py).

The source is the repo's native/knox_native.cc, read and never edited
here. On first use it is built with g++ (the flags of knoxdb_tpu) into
knoxdb_tpu_torch/_build/, under a name that hashes the source, the flags
and the host (-march=native code does not move between machines), never
into native/build/; nothing is built at import time. Every entry point
keeps its numpy fallback, which gives the same bits: a host without a
toolchain runs the fallbacks. `require()`
builds the library or raises with g++'s message, for callers that must
not fall back. These are host kernels of the write path (bit-plane
transpose, one-pass analysis, LZ4 blocks); the device side is ops/ and
csrc/."""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import time
from pathlib import Path

import numpy as np

__all__ = ["lib", "bitplane_pack", "bitplane_unpack", "analyze_u64",
           "bitset_indexes", "available", "require", "build_info",
           "lz4_compress", "lz4_decompress", "bitplane_unpack_np",
           "analyze_u64_np", "bitset_indexes_np", "lz4_compress_np",
           "lz4_decompress_np"]

_SRC = Path(__file__).resolve().parents[2] / "native" / "knox_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

lib = None
_tried = False
build_info: dict = {}    # seconds (0.0 for a cached library), library, error


def _host_tag() -> bytes:
    """What -march=native compiles for: the machine and its CPU model."""
    tag = [platform.machine(), platform.node()]
    try:
        with open("/proc/cpuinfo") as fh:
            tag += [ln for ln in fh if ln.startswith("model name")][:1]
    except OSError:
        pass
    return "|".join(tag).encode()


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    h.update(_host_tag())
    return BUILD_DIR / f"libknox_native_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    so = _so_path()
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        r = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ exit {r.returncode}: {r.stderr}")
        os.replace(tmp, so)
    build_info.update(seconds=time.perf_counter() - t0, library=str(so))
    return so


def _bind(so: Path):
    L = ctypes.CDLL(str(so))
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    L.bitplane_pack.argtypes = [u64p, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int32, u32p]
    L.bitplane_unpack.argtypes = [u32p, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int32, u64p]
    L.analyze_u64.argtypes = [u64p, ctypes.c_int64, u64p]
    L.bitset_indexes.argtypes = [u32p, ctypes.c_int64, ctypes.c_uint32,
                                 u32p]
    L.bitset_indexes.restype = ctypes.c_int64
    L.lz4_compress.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
    L.lz4_compress.restype = ctypes.c_int64
    L.lz4_decompress.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
    L.lz4_decompress.restype = ctypes.c_int64
    return L


def _load():
    """The bound library, built on first use; None where it cannot be."""
    global lib, _tried
    if not _tried:
        _tried = True
        try:
            lib = _bind(_build())
        except Exception as e:             # no g++, a failed build or load
            build_info["error"] = f"{type(e).__name__}: {e}"
    return lib


def available() -> bool:
    return _load() is not None


def require():
    """The bound library; raises where it does not build or load."""
    if _load() is None:
        raise RuntimeError(f"native library unavailable: "
                           f"{build_info.get('error')}")
    return lib


def bitplane_pack(values: np.ndarray, width: int, n_pad: int) -> np.ndarray:
    """u64[n] -> u32[max(width, 1), n_pad//32] bitplanes."""
    n = len(values)
    w = max(width, 1)
    if _load() is not None and n:
        out = np.empty((w, n_pad // 32), np.uint32)
        vals = np.ascontiguousarray(values, np.uint64)
        lib.bitplane_pack(vals, n, n_pad, width, out)
        if width == 0:
            out[:] = 0
        return out
    from ..encode.schemes import _pack_bitplanes_np
    return _pack_bitplanes_np(values, width, n_pad)


def bitplane_unpack(planes: np.ndarray, width: int, n: int) -> np.ndarray:
    if _load() is not None and n:
        out = np.empty(n, np.uint64)
        p = np.ascontiguousarray(planes, np.uint32)
        lib.bitplane_unpack(p, n, p.shape[1] * 32, width, out)
        return out
    return bitplane_unpack_np(planes, width, n)


def bitplane_unpack_np(planes: np.ndarray, width: int, n: int) -> np.ndarray:
    vals = np.zeros(planes.shape[1] * 32, np.uint64)
    for b in range(width):
        bits = np.unpackbits(planes[b].view(np.uint8),
                             bitorder="little").astype(np.uint64)
        vals |= bits << np.uint64(b)
    return vals[:n]


def analyze_u64(values: np.ndarray):
    """(min, max, num_runs, delta_width, pack_width, sorted)."""
    if _load() is not None and len(values):
        out = np.empty(6, np.uint64)
        vals = np.ascontiguousarray(values, np.uint64)
        lib.analyze_u64(vals, len(vals), out)
        return (int(out[0]), int(out[1]), int(out[2]), int(out[3]),
                int(out[4]), bool(out[5]))
    return analyze_u64_np(values)


def analyze_u64_np(values: np.ndarray):
    keys = np.asarray(values, np.uint64)
    mn, mx = int(keys.min()), int(keys.max())
    runs = 1 + int((keys[1:] != keys[:-1]).sum())
    if len(keys) > 1:
        with np.errstate(over="ignore"):
            d = (keys[1:] - keys[:-1]).view(np.int64)
            zz = ((d << 1) ^ (d >> 63)).view(np.uint64)
        dw = int(zz.max()).bit_length()
        sorted_ = bool((d >= 0).all())
    else:
        dw, sorted_ = 0, True
    return mn, mx, runs, dw, (mx - mn).bit_length(), sorted_


def bitset_indexes(words: np.ndarray, base: int = 0) -> np.ndarray:
    if _load() is not None:
        w = np.ascontiguousarray(words, np.uint32)
        cap = int(np.bitwise_count(w).sum()) if hasattr(np, "bitwise_count") \
            else int(sum(bin(int(x)).count("1") for x in w))
        out = np.empty(max(cap, 1), np.uint32)
        k = lib.bitset_indexes(w, len(w), base, out)
        return out[:k]
    return bitset_indexes_np(words, base)


def bitset_indexes_np(words: np.ndarray, base: int = 0) -> np.ndarray:
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return (np.flatnonzero(bits) + base).astype(np.uint32)


# ------------------------------------------------------------------ lz4 --
# LZ4 block codec: native C++ where the library builds; the python
# versions keep the decode-any-codec contract of store/segio.py without
# a toolchain (the fallback writes literal-only blocks).

def lz4_compress(data: bytes) -> bytes:
    src = np.frombuffer(data, np.uint8)
    n = len(src)
    if _load() is not None:
        cap = n + n // 255 + 16
        out = np.empty(cap, np.uint8)
        src_c = np.ascontiguousarray(src)
        k = lib.lz4_compress(src_c if n else np.zeros(1, np.uint8), n,
                             out, cap)
        if k > 0:
            return out[:k].tobytes()
    return lz4_compress_np(data)


def lz4_compress_np(data: bytes) -> bytes:
    """A literal-only LZ4 block (valid, decodable, ratio 1.0)."""
    out = bytearray()
    lit = len(data)
    if lit >= 15:
        out.append(15 << 4)
        r = lit - 15
        while r >= 255:
            out.append(255)
            r -= 255
        out.append(r)
    else:
        out.append(lit << 4)
    out += data
    return bytes(out)


def lz4_decompress(data: bytes, out_len: int) -> bytes:
    src = np.frombuffer(data, np.uint8)
    if _load() is not None:
        out = np.empty(max(out_len, 1), np.uint8)
        src_c = np.ascontiguousarray(src)
        k = lib.lz4_decompress(src_c if len(src) else
                               np.zeros(1, np.uint8), len(src),
                               out, out_len)
        if k == out_len:
            return out[:k].tobytes()
        if k >= 0:
            raise ValueError(f"lz4: decoded {k} != expected {out_len}")
        raise ValueError("lz4: malformed block")
    return lz4_decompress_np(data, out_len)


def lz4_decompress_np(data: bytes, out_len: int) -> bytes:
    """Any LZ4 block -> its bytes in python (slow; correctness only).
    Truncated input raises the native path's ValueError, never a bare
    IndexError."""
    try:
        ip, iend = 0, len(data)
        out = bytearray()
        while ip < iend:
            token = data[ip]
            ip += 1
            lit = token >> 4
            if lit == 15:
                while True:
                    b = data[ip]
                    ip += 1
                    lit += b
                    if b != 255:
                        break
            if ip + lit > iend:
                raise ValueError("lz4: truncated literals")
            out += data[ip:ip + lit]
            ip += lit
            if ip >= iend:
                break
            off = data[ip] | (data[ip + 1] << 8)
            ip += 2
            if off == 0 or off > len(out):
                raise ValueError("lz4: bad offset")
            mlen = (token & 15) + 4
            if (token & 15) == 15:
                while True:
                    b = data[ip]
                    ip += 1
                    mlen += b
                    if b != 255:
                        break
            for _ in range(mlen):
                out.append(out[-off])
    except IndexError:
        raise ValueError("lz4: malformed block") from None
    if len(out) != out_len:
        raise ValueError(f"lz4: decoded {len(out)} != expected {out_len}")
    return bytes(out)
