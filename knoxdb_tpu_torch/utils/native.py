"""Host kernels of the encode and storage paths, as numpy (carried over
from knoxdb_tpu/utils/native.py).

The reference binds native/knox_native.cc with ctypes and keeps a numpy
fallback for every entry point. This module holds those fallbacks only:
`lib` stays None and `available()` False until the port builds the same
library (ROADMAP.md, item 12). The literal-only `lz4_compress` writes
valid LZ4 blocks that any LZ4 decoder reads, and `lz4_decompress` reads
any block, the reference's native ones included."""

from __future__ import annotations

import numpy as np

__all__ = ["lib", "bitplane_pack", "bitplane_unpack", "analyze_u64",
           "bitset_indexes", "available", "lz4_compress",
           "lz4_decompress"]

lib = None


def available() -> bool:
    return lib is not None


def bitplane_pack(values: np.ndarray, width: int, n_pad: int) -> np.ndarray:
    """u64[n] -> u32[width, n_pad//32] bitplanes."""
    from ..encode.schemes import _pack_bitplanes_np
    return _pack_bitplanes_np(values, width, n_pad)


def bitplane_unpack(planes: np.ndarray, width: int, n: int) -> np.ndarray:
    vals = np.zeros(planes.shape[1] * 32, np.uint64)
    for b in range(width):
        bits = np.unpackbits(planes[b].view(np.uint8),
                             bitorder="little").astype(np.uint64)
        vals |= bits << np.uint64(b)
    return vals[:n]


def analyze_u64(values: np.ndarray):
    """(min, max, num_runs, delta_width, pack_width, sorted)."""
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
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return (np.flatnonzero(bits) + base).astype(np.uint32)


# ------------------------------------------------------------------ lz4 --
# LZ4 block codec: python versions that keep the decode-any-codec
# contract of store/segio.py.

def lz4_compress(data: bytes) -> bytes:
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
    """Any LZ4 block -> its bytes (slow; correctness only). Truncated
    input raises ValueError, never a bare IndexError."""
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
