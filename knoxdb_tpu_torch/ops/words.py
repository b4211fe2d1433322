"""u32 words carried as int32 tensors.

Torch has no full set of uint32 ops on every device (on the CPU `~`,
`<<`, `>>`, `+` and `max` raise for uint32), so the port carries every
packed word as an int32 tensor holding the same 32 bits. `&`, `|`, `^`
and `~` are the same on both readings; right shifts of int32 are
arithmetic, so `lsr` masks the sign copies off; counts never go through
a signed overflow. u64 keys stay on the host, split into u32 halves.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["FULL", "to_words", "from_words", "lsr", "popcount",
           "split_u64", "join_u64", "u32_from_i64"]

FULL = -1          # 0xFFFFFFFF read as int32


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


def split_u64(a) -> tuple[np.ndarray, np.ndarray]:
    """Host u64 -> (lo u32, hi u32)."""
    a = np.asarray(a, np.uint64)
    return ((a & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (a >> np.uint64(32)).astype(np.uint32))


def join_u64(lo, hi) -> np.ndarray:
    """Host (lo u32, hi u32) -> u64."""
    return (np.asarray(hi, np.uint32).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(lo, np.uint32).astype(np.uint64)
