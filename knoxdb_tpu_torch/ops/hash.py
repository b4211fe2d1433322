"""Murmur3-style 32-bit hashing over keyform limbs, bit-identical to
knoxdb_tpu/ops/hash.py: host (numpy) versions for the pack filters built
at encode time, and device (torch) versions on int32-carried u32 words
(ops/words.py) that give the same bits."""

from __future__ import annotations

import numpy as np
import torch

from . import words as WD

__all__ = ["hash32", "hash32_np", "hash2", "hash2_np", "mix32"]

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_FMIX1 = 0x85EBCA6B
_FMIX2 = 0xC2B2AE35
_M32 = 0xFFFFFFFF


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


# --- device: u32 values held in int64 tensors in [0, 2^32) ---

def _t_mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 without an int64 overflow (16-bit halves of x)."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _t_rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _t_fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _t_mul(h, _FMIX1)
    h = h ^ (h >> 13)
    h = _t_mul(h, _FMIX2)
    return h ^ (h >> 16)


def hash32(limbs: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """int32[L, *s] u32 words -> int32[*s] words (device); the bits of
    hash32_np."""
    h = torch.full(limbs.shape[1:], (seed ^ 0x9747B28C) & _M32,
                   dtype=torch.int64, device=limbs.device)
    for l in range(limbs.shape[0]):
        k = _t_mul(WD.u32_to_i64(limbs[l]), _C1)
        k = _t_mul(_t_rotl(k, 15), _C2)
        h = _t_rotl(h ^ k, 13)
        h = (_t_mul(h, 5) + 0xE6546B64) & _M32
    return WD.u32_from_i64(_t_fmix(h))


def hash2(limbs: torch.Tensor):
    """Two independent 32-bit hashes (device) for double-hashing bloom
    probes."""
    return hash32(limbs, 0), hash32(limbs, 0x8BADF00D)


def mix32(x, xp=np):
    """Single-word finalizer (fast partition/bucket hash for u32 codes).
    xp=np: numpy u32 in and out; xp=torch: int32-carried words."""
    if xp is np:
        with np.errstate(over="ignore"):
            return _fmix(np.asarray(x).astype(np.uint32))
    return WD.u32_from_i64(_t_fmix(WD.u32_to_i64(x)))
