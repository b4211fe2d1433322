"""u32 words carried as int32 tensors.

Torch has no full set of uint32 ops on every device (on the CPU `~`,
`<<`, `>>`, `+` and `max` raise for uint32), so the port carries every
packed word as an int32 tensor holding the same 32 bits. `&`, `|`, `^`
and `~` are the same on both readings; right shifts of int32 are
arithmetic, so `lsr` masks the sign copies off; counts never go through
a signed overflow. u64 keys stay on the host, split into u32 halves; on
the device a u64 is a pair of such words (lo, hi), or, where it must be
ordered or searched, an order-preserving int64 (`ordered_i64`).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["FULL", "to_words", "from_words", "lsr", "popcount",
           "split_u64", "join_u64", "u32_from_i64", "u32_to_i64",
           "ordered_i64", "ordered_from_u64", "u64_from_ordered",
           "bits_i64", "halves_of_bits", "bits_from_u64", "lsr64"]

FULL = -1          # 0xFFFFFFFF read as int32
_I32_MIN = -(1 << 31)
I64_MIN = -(1 << 63)
_BIT63 = np.uint64(1 << 63)


def to_words(a, device) -> torch.Tensor:
    """numpy u32 array -> int32 tensor with the same bits, on `device`."""
    a = np.ascontiguousarray(a, np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def from_words(t: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> numpy u32 array with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32)


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32-carried u32 words by 1 <= s <= 31."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _popcount16(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of values in [0, 2^16): every step stays positive."""
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits per int32-carried u32 word (int32 result, 0..32)."""
    return _popcount16(x & 0xFFFF) + _popcount16(lsr(x, 16))


def u32_from_i64(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor holding the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def u32_to_i64(x: torch.Tensor) -> torch.Tensor:
    """int32-carried u32 words -> int64 values in [0, 2^32)."""
    return x.to(torch.int64) & 0xFFFFFFFF


def ordered_i64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """u64 halves (int32-carried) -> the order-preserving int64 key: the
    u64 with bit 63 flipped, read as int64, so x < y as u64 iff
    ordered(x) < ordered(y). No step overflows: the flipped high word read
    as int32 times 2^32 plus the low word stays inside int64."""
    return (hi ^ _I32_MIN).to(torch.int64) * (1 << 32) + u32_to_i64(lo)


def bits_i64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """u64 halves (int32-carried) -> int64 holding the same 64 bits: the
    port's form of a device u64 where only wrapping arithmetic (add,
    subtract, cumsum mod 2^64) and equality are needed. Its signed order
    is NOT the u64 order; flip bit 63 (`^ I64_MIN`) for `ordered_i64`."""
    return hi.to(torch.int64) * (1 << 32) + u32_to_i64(lo)


def halves_of_bits(k: torch.Tensor):
    """int64 holding u64 bits -> (lo, hi) int32-carried u32 halves."""
    return u32_from_i64(k & 0xFFFFFFFF), (k >> 32).to(torch.int32)


def lsr64(k: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64-carried u64 bits by 1 <= s <= 63."""
    return (k >> s) & ((1 << (64 - s)) - 1)


def bits_from_u64(a) -> np.ndarray:
    """Host u64 -> int64 with the same bits (for `bits_i64` tensors)."""
    return np.ascontiguousarray(a, np.uint64).view(np.int64)


def ordered_from_u64(a) -> np.ndarray:
    """Host u64 -> the int64 keys of `ordered_i64`."""
    return (np.asarray(a, np.uint64) ^ _BIT63).view(np.int64)


def u64_from_ordered(a) -> np.ndarray:
    """Host int64 keys of `ordered_i64` -> u64."""
    return np.ascontiguousarray(a, np.int64).view(np.uint64) ^ _BIT63


def split_u64(a) -> tuple[np.ndarray, np.ndarray]:
    """Host u64 -> (lo u32, hi u32)."""
    a = np.asarray(a, np.uint64)
    return ((a & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (a >> np.uint64(32)).astype(np.uint32))


def join_u64(lo, hi) -> np.ndarray:
    """Host (lo u32, hi u32) -> u64."""
    return (np.asarray(hi, np.uint32).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(lo, np.uint32).astype(np.uint64)
