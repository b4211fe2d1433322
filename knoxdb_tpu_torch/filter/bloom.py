"""Per-pack bloom filters for pack pruning (the host half of
knoxdb_tpu/filter/bloom.py, bit-identical to it).

k=4 probes derived by double hashing from two 32-bit hashes
(ops/hash.py), a power-of-two bit count, 1 byte/entry -> ~2% fpr and
2 bytes/entry -> ~0.2% fpr. Filters are u32 word arrays.
"""

from __future__ import annotations

import numpy as np

from ..ops import hash as H
from ..types import FilterType

__all__ = ["bloom_bits", "build_np", "contains_np", "contains_any_np",
           "build_bytes_np", "contains_bytes_np", "BLOOM_K"]

BLOOM_K = 4

_BYTES_PER_ENTRY = {
    FilterType.BLOOM_1B: 1, FilterType.BLOOM_2B: 2,
    FilterType.BLOOM_3B: 3, FilterType.BLOOM_4B: 4,
    FilterType.BLOOM_5B: 5,
}


def bloom_bits(n_entries: int, ftype: FilterType) -> int:
    """Power-of-two bit count for n entries at the configured scale.
    Strict on the filter kind: a non-bloom kind raises."""
    b = _BYTES_PER_ENTRY.get(ftype)
    if b is None:
        raise ValueError(f"bloom_bits: {ftype!r} is not a bloom filter "
                         f"kind; BITS/BFUSE build their own structures")
    want = max(64, n_entries * b * 8)
    return 1 << (want - 1).bit_length()


def _probe_positions(h1, h2, nbits: int):
    mask = np.uint32(nbits - 1)
    with np.errstate(over="ignore"):
        return [(h1 + np.uint32(i) * h2) & mask for i in range(BLOOM_K)]


def _set_bits(h1, h2, nbits: int) -> np.ndarray:
    words = np.zeros(nbits // 32, np.uint32)
    for pos in _probe_positions(h1, h2, nbits):
        np.bitwise_or.at(words, pos >> 5,
                         np.uint32(1) << (pos & np.uint32(31)))
    return words


def _test_bits(words: np.ndarray, h1, h2) -> np.ndarray:
    nbits = words.shape[-1] * 32
    out = np.ones(np.shape(h1), bool)
    for pos in _probe_positions(h1, h2, nbits):
        bit = (words[pos >> 5] >> (pos & np.uint32(31))) & np.uint32(1)
        out &= bit.astype(bool)
    return out


def build_np(limbs: np.ndarray, nbits: int) -> np.ndarray:
    """Build from keyform limbs u32[L, N] -> packed u32[nbits/32]."""
    assert nbits & (nbits - 1) == 0
    return _set_bits(*H.hash2_np(limbs), nbits)


def contains_np(words: np.ndarray, limbs: np.ndarray) -> np.ndarray:
    """Probe: u32[L, K] keys -> bool[K] (maybe-contained)."""
    return _test_bits(words, *H.hash2_np(limbs))


def contains_any_np(words: np.ndarray, limbs: np.ndarray) -> bool:
    return bool(contains_np(words, limbs).any())


def _bytes_hashes(vals: list) -> tuple[np.ndarray, np.ndarray]:
    """Two independent 32-bit hashes per byte string (blake2b)."""
    import hashlib
    h1 = np.empty(len(vals), np.uint32)
    h2 = np.empty(len(vals), np.uint32)
    for i, b in enumerate(vals):
        d = hashlib.blake2b(b, digest_size=8).digest()
        h1[i] = int.from_bytes(d[:4], "little")
        h2[i] = int.from_bytes(d[4:], "little")
    return h1, h2


def build_bytes_np(vals: list, nbits: int) -> np.ndarray:
    """Bloom over full byte values (STRING/BYTES pack pruning)."""
    assert nbits & (nbits - 1) == 0
    return _set_bits(*_bytes_hashes(vals), nbits)


def contains_bytes_np(words: np.ndarray, vals: list) -> np.ndarray:
    return _test_bits(words, *_bytes_hashes(vals))
