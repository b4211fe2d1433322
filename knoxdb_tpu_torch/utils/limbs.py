"""Order-preserving uint32 limb ("key form") conversion (carried over from
knoxdb_tpu/utils/limbs.py).

Every fixed-width logical type is mapped on the host to an array of uint32
limbs, limb 0 most significant, such that lexicographic unsigned comparison
of limbs == the logical ordering of the values:

- unsigned ints: value split big-endian into 32-bit limbs
- signed ints:   value XOR 2^(bits-1) (bias flip), then split
- floats:        IEEE bits; negative -> all bits inverted, else sign bit set
                 (total order; NaN sorts above +inf)
- decimals:      underlying scaled integer of the same width
- bool:          0/1 in one limb
"""

from __future__ import annotations

import numpy as np

from ..types import FieldType

__all__ = [
    "to_keyform", "to_keys64", "from_keyform", "scalar_to_keyform",
    "keyform_to_scalar", "numpy_dtype",
]

_NP_DTYPES = {
    FieldType.TIMESTAMP: np.int64, FieldType.TIME: np.int64,
    FieldType.INT64: np.int64, FieldType.UINT64: np.uint64,
    FieldType.FLOAT64: np.float64, FieldType.FLOAT32: np.float32,
    FieldType.INT32: np.int32, FieldType.UINT32: np.uint32,
    FieldType.INT16: np.int16, FieldType.UINT16: np.uint16,
    FieldType.INT8: np.int8, FieldType.UINT8: np.uint8,
    FieldType.BOOLEAN: np.bool_,
    FieldType.DECIMAL32: np.int32, FieldType.DECIMAL64: np.int64,
}


def numpy_dtype(ft: FieldType):
    """Native numpy dtype for a fixed-width type; object for 128/256-bit."""
    return _NP_DTYPES.get(ft, object)


def _float_to_key_bits(bits: np.ndarray, sign_mask: int, full: int) -> np.ndarray:
    # IEEE: -0.0 == 0.0, but the order-preserving bit map would give the
    # two zeros ADJACENT keys (so `x < 0.0` matched -0.0 rows, diverging
    # from the reference's IEEE compares). Canonicalize the -0.0 pattern
    # to +0.0 before mapping; -0.0 therefore materializes as +0.0 —
    # numerically equal, documented deviation.
    bits = np.where(bits == np.array(sign_mask, bits.dtype),
                    np.zeros((), bits.dtype), bits)
    neg = (bits & sign_mask) != 0
    return np.where(neg, bits ^ np.array(full, bits.dtype),
                    bits | np.array(sign_mask, bits.dtype))


def _key_bits_to_float(key: np.ndarray, sign_mask: int, full: int) -> np.ndarray:
    was_pos = (key & sign_mask) != 0
    return np.where(was_pos, key ^ np.array(sign_mask, key.dtype),
                    key ^ np.array(full, key.dtype))


def to_keyform(values, ft: FieldType) -> np.ndarray:
    """Convert host values -> uint32 limbs of shape (nlimbs, N).

    Single-pass: 64-bit keys split into limbs via a zero-copy u32 view
    (little-endian reinterpret), so the whole conversion is one or two
    elementwise passes over the data."""
    L = ft.nlimbs
    if ft.bits > 64:
        return _wide_to_keyform(values, ft)

    v = np.asarray(values, dtype=numpy_dtype(ft))
    if ft is FieldType.FLOAT64:
        bits = v.view(np.uint64)
        key = _float_to_key_bits(bits, 1 << 63, (1 << 64) - 1)
    elif ft is FieldType.FLOAT32:
        bits = v.view(np.uint32)
        key = _float_to_key_bits(bits, 1 << 31, (1 << 32) - 1)
    elif ft is FieldType.BOOLEAN:
        key = v.astype(np.uint32)
    elif ft.is_signed:
        if ft.bits == 64:
            key = v.view(np.uint64) if v.dtype == np.int64 else \
                np.asarray(v, np.int64).view(np.uint64)
            key = key ^ np.uint64(1 << 63)
        else:
            # widen small signed ints through int64 to avoid view pitfalls
            key = (v.astype(np.int64) + (1 << (ft.bits - 1))).astype(np.uint64)
    else:
        key = v if v.dtype == np.uint64 else v.astype(np.uint64)

    if L == 1:
        return np.ascontiguousarray(key.astype(np.uint32))[None, :]
    key = np.ascontiguousarray(key, np.uint64)
    pairs = key.view(np.uint32)            # little-endian: lo, hi, lo, hi...
    out = np.empty((2, len(key)), np.uint32)
    out[0] = pairs[1::2]                   # hi limb (most significant)
    out[1] = pairs[0::2]                   # lo limb
    return out


def _wide_to_keyform(values, ft: FieldType) -> np.ndarray:
    """128/256-bit ints (python int sequence / object array) -> limbs.
    Vectorized object-int arithmetic (numpy-driven elementwise python
    ops, ~10x over an interpreted per-value loop)."""
    L = ft.nlimbs
    bits = ft.bits
    bias = 1 << (bits - 1) if ft.is_signed else 0
    mod = 1 << bits
    x = np.array([int(v) for v in values], object)
    x = (x + bias) % mod if ft.is_signed else x % mod
    out = np.empty((L, len(x)), dtype=np.uint32)
    m32 = (1 << 32) - 1
    for l in range(L - 1, -1, -1):
        out[l] = (x & m32).astype(np.uint64).astype(np.uint32)
        x = x >> 32
    return out


def to_keys64(values, ft: FieldType) -> np.ndarray:
    """Host values -> u64 keyform keys (types up to 64 bits), one pass."""
    assert ft.bits <= 64 and not ft.is_bytes_like
    v = np.asarray(values, dtype=numpy_dtype(ft))
    if ft is FieldType.FLOAT64:
        return _float_to_key_bits(v.view(np.uint64), 1 << 63, (1 << 64) - 1)
    if ft is FieldType.FLOAT32:
        k32 = _float_to_key_bits(v.view(np.uint32), 1 << 31, (1 << 32) - 1)
        return k32.astype(np.uint64)
    if ft is FieldType.BOOLEAN:
        return v.astype(np.uint64)
    if ft.is_signed:
        if ft.bits == 64:
            key = v.view(np.uint64) if v.dtype == np.int64 else \
                np.asarray(v, np.int64).view(np.uint64)
            return key ^ np.uint64(1 << 63)
        return (v.astype(np.int64) + (1 << (ft.bits - 1))).astype(np.uint64)
    return v.astype(np.uint64)


def from_keyform(limbs: np.ndarray, ft: FieldType):
    """Inverse of to_keyform. limbs: uint32 (nlimbs, N)."""
    L = ft.nlimbs
    limbs = np.asarray(limbs, dtype=np.uint32)
    if ft.bits > 64:
        bias = 1 << (ft.bits - 1) if ft.is_signed else 0
        acc = limbs[0].astype(object)          # vectorized object math
        for l in range(1, L):
            acc = (acc << 32) + limbs[l].astype(object)
        return acc - bias if ft.is_signed else acc

    if L == 2:
        key = (limbs[0].astype(np.uint64) << np.uint64(32)) | limbs[1].astype(np.uint64)
    else:
        key = limbs[0].astype(np.uint64)

    if ft is FieldType.FLOAT64:
        return _key_bits_to_float(key, 1 << 63, (1 << 64) - 1).view(np.float64)
    if ft is FieldType.FLOAT32:
        k32 = key.astype(np.uint32)
        return _key_bits_to_float(k32, 1 << 31, (1 << 32) - 1).view(np.float32)
    if ft is FieldType.BOOLEAN:
        return key.astype(np.bool_)
    if ft.is_signed:
        if ft.bits == 64:
            return (key ^ np.uint64(1 << 63)).view(np.int64)
        signed = key.astype(np.int64) - (1 << (ft.bits - 1))
        return signed.astype(numpy_dtype(ft))
    return key.astype(numpy_dtype(ft))


def scalar_to_keyform(value, ft: FieldType) -> tuple[int, ...]:
    """Single value -> tuple of nlimbs python ints (for filter constants)."""
    if ft.bits > 64:
        arr = _wide_to_keyform([value], ft)
        return tuple(int(arr[l, 0]) for l in range(ft.nlimbs))
    limbs = to_keyform(np.array([value], dtype=numpy_dtype(ft)), ft)
    return tuple(int(limbs[l, 0]) for l in range(ft.nlimbs))


def keyform_to_scalar(limbs: tuple[int, ...], ft: FieldType):
    arr = np.array([[l] for l in limbs], dtype=np.uint32)
    out = from_keyform(arr, ft)
    return out[0] if not isinstance(out, np.ndarray) or out.ndim else out
