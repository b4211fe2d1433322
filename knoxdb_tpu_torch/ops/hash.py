"""Host (numpy) murmur3-style hashing over keyform limbs, bit-identical to
knoxdb_tpu/ops/hash.py, for the bloom filters built at encode time."""

from __future__ import annotations

import numpy as np

__all__ = ["hash32_np", "hash2_np"]

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_FMIX1 = 0x85EBCA6B
_FMIX2 = 0xC2B2AE35


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _mm3_combine(h, k):
    k = k * np.uint32(_C1)
    k = _rotl(k, 15)
    k = k * np.uint32(_C2)
    h = h ^ k
    h = _rotl(h, 13)
    return h * np.uint32(5) + np.uint32(0xE6546B64)


def _fmix(h):
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(_FMIX1)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(_FMIX2)
    return h ^ (h >> np.uint32(16))


def hash32_np(limbs: np.ndarray, seed: int = 0) -> np.ndarray:
    """u32[L, *s] -> u32[*s]."""
    limbs = np.asarray(limbs, np.uint32)
    with np.errstate(over="ignore"):
        h = np.uint32(seed ^ 0x9747B28C)
        for l in range(limbs.shape[0]):
            h = _mm3_combine(h, limbs[l])
        return _fmix(h)


def hash2_np(limbs: np.ndarray):
    """Two independent 32-bit hashes for double-hashing bloom probes."""
    return hash32_np(limbs, 0), hash32_np(limbs, 0x8BADF00D)
