"""Packed bitsets, 32 rows per int32-carried u32 word (ops/words.py).

Bit order: bit k of word w = row w*32 + k (LSB-first within the word),
the format of knoxdb_tpu/ops/bitset.py.
"""

from __future__ import annotations

import numpy as np
import torch

from . import words as WD

__all__ = ["pack_mask", "unpack_mask", "popcount", "np_pack_mask",
           "np_unpack_mask", "np_indexes"]

_WEIGHTS = [1 << k for k in range(32)]


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool[..., N] -> int32[..., N//32] packed words."""
    n = mask.shape[-1]
    if n % 32:
        raise ValueError("mask length must be a multiple of 32")
    m = mask.reshape(*mask.shape[:-1], n // 32, 32).to(torch.int64)
    w = torch.tensor(_WEIGHTS, dtype=torch.int64, device=mask.device)
    return WD.u32_from_i64((m * w).sum(dim=-1))


def unpack_mask(words: torch.Tensor) -> torch.Tensor:
    """int32[..., W] -> bool[..., W*32]."""
    sh = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = ((words[..., None] >> sh) & 1).to(torch.bool)
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32)


def popcount(words: torch.Tensor) -> int:
    """Total set bits."""
    return int(WD.popcount(words).sum(dtype=torch.int64))


def np_pack_mask(mask: np.ndarray) -> np.ndarray:
    """Host bool[N] -> u32[ceil(N/32)]."""
    n = mask.shape[-1]
    pad = (-n) % 32
    if pad:
        mask = np.concatenate([mask, np.zeros(pad, dtype=bool)])
    return np.packbits(mask.reshape(-1, 32), axis=-1,
                       bitorder="little").view(np.uint32).reshape(-1)


def np_unpack_mask(words: np.ndarray, n: int) -> np.ndarray:
    bits = np.unpackbits(np.ascontiguousarray(words, np.uint32).view(np.uint8),
                         bitorder="little")
    return bits[:n].astype(bool)


def np_indexes(mask: np.ndarray) -> np.ndarray:
    """Selection vector (row indices of set bits), host side; device
    compaction lives in ops/compact.py."""
    return np.flatnonzero(mask).astype(np.uint32)
