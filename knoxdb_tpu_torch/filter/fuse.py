"""Binary fuse / xor filters (8- and 16-bit fingerprints) (carried over from
knoxdb_tpu/filter/fuse.py).

Analog of the reference fuse filters (internal/filter/
fuse wrapping FastFilter/xorfilter, 8/16-bit; built per pack in
internal/pack/stats/filter.go:68-85): a static membership filter at
~9.8 bits/key with ~0.39% fpr for 8-bit fingerprints (~19.7 bits/key,
~0.0015% fpr for 16-bit; xor construction — the reference's binary-fuse
variant trades a denser layout for the same contract).
Build by hypergraph peeling over three hash positions; query = 3 loads +
xor compare. Used as a per-pack alternative to bloom when packs are
sealed (build once, never mutate): at equal bytes the fuse filter's fpr
beats bloom's.
"""

from __future__ import annotations

import numpy as np

from ..ops import hash as H

__all__ = ["XorFilter", "build", "build_bytes"]

_FP_DTYPE = {8: np.uint8, 16: np.uint16}


def _mix(h: np.ndarray, seed: int) -> np.ndarray:
    return H.mix32((h ^ np.uint32(seed)).astype(np.uint32), np)


class XorFilter:
    def __init__(self, seed: int, fingerprints: np.ndarray):
        self.seed = seed
        self.fp = fingerprints            # u8|u16[3 * block]
        self.block = len(fingerprints) // 3

    @property
    def fp_bits(self) -> int:
        return self.fp.dtype.itemsize * 8

    def _positions(self, h1: np.ndarray, h2: np.ndarray):
        base = (h1.astype(np.uint64) << np.uint64(32)) | h2
        hs = []
        for i in range(3):
            hi = _mix((base >> np.uint64(16 * i)).astype(np.uint32),
                      self.seed + i)
            hs.append((hi % np.uint32(self.block)).astype(np.int64)
                      + i * self.block)
        fmask = np.uint32((1 << self.fp_bits) - 1)
        fp = (_mix(h1 ^ h2, self.seed ^ 0xABCD1234) & fmask) \
            .astype(self.fp.dtype)
        return hs, fp

    def contains_hashes(self, h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
        (p0, p1, p2), fp = self._positions(h1, h2)
        return (self.fp[p0] ^ self.fp[p1] ^ self.fp[p2]) == fp

    def contains_limbs(self, limbs: np.ndarray) -> np.ndarray:
        h1, h2 = H.hash2_np(limbs)
        return self.contains_hashes(h1, h2)

    def contains_bytes(self, vals: list) -> np.ndarray:
        from .bloom import _bytes_hashes
        h1, h2 = _bytes_hashes(vals)
        return self.contains_hashes(h1, h2)

    @property
    def nbytes(self) -> int:
        return self.fp.nbytes


def _try_build(h1: np.ndarray, h2: np.ndarray, block: int, seed: int,
               fp_bits: int):
    """Vectorized ROUND-BASED peeling (the classic stack peel is O(n)
    python per pack — too slow at 64K keys): each round resolves ALL
    currently-single slots at once. Correctness of the batched
    fingerprint assignment: a key's assignment slot has count 1 among
    keys alive at its round start, so no other key — same round or any
    later-peeled round — ever writes that slot; reverse-round
    assignment therefore reads exactly the final values the sequential
    algorithm would."""
    f = XorFilter(seed, np.zeros(3 * block, _FP_DTYPE[fp_bits]))
    (p0, p1, p2), fp = f._positions(h1, h2)
    pos = np.stack([p0, p1, p2], axis=1)      # [n, 3]
    n = len(h1)
    m = 3 * block
    count = np.bincount(pos.reshape(-1), minlength=m)
    xor_acc = np.zeros(m, np.int64)
    ids3 = np.repeat(np.arange(1, n + 1, dtype=np.int64), 3)
    np.bitwise_xor.at(xor_acc, pos.reshape(-1), ids3)   # 1-based key ids
    alive = np.ones(n, bool)
    n_alive = n
    rounds: list[tuple[np.ndarray, np.ndarray]] = []
    while n_alive:
        single = np.flatnonzero(count == 1)
        ks = xor_acc[single] - 1              # the lone occupant's id
        ok = (ks >= 0) & (ks < n)
        ks, sl = ks[ok], single[ok]
        ok = alive[ks]
        ks, sl = ks[ok], sl[ok]
        # a key can be the lone occupant of several slots: keep one
        uq, first = np.unique(ks, return_index=True)
        ks, sl = ks[first], sl[first]
        if not len(ks):
            return None                        # cycle: retry new seed
        rounds.append((ks, sl))
        alive[ks] = False
        n_alive -= len(ks)
        rem = pos[ks].reshape(-1)
        np.subtract.at(count, rem, 1)
        np.bitwise_xor.at(xor_acc, rem, np.repeat(ks + 1, 3))
    fps = np.zeros(m, _FP_DTYPE[fp_bits])
    for ks, sl in reversed(rounds):
        fps[sl] = (fp[ks] ^ fps[pos[ks, 0]] ^ fps[pos[ks, 1]]
                   ^ fps[pos[ks, 2]])
        # note: fps[sl] included itself as 0 before assignment
    f.fp = fps
    return f


def build(limbs: np.ndarray, fp_bits: int = 8) -> XorFilter:
    """Keyform limbs u32[L, N] (unique keys) -> xor filter."""
    h1, h2 = H.hash2_np(limbs)
    return _build_hashes(h1, h2, fp_bits)


def build_bytes(vals: list, fp_bits: int = 8) -> XorFilter:
    from .bloom import _bytes_hashes
    h1, h2 = _bytes_hashes(vals)
    return _build_hashes(h1, h2, fp_bits)


def _build_hashes(h1: np.ndarray, h2: np.ndarray,
                  fp_bits: int = 8) -> XorFilter:
    # duplicates break peeling: dedupe on the combined 64-bit hash
    base = (h1.astype(np.uint64) << np.uint64(32)) | h2
    _, keep = np.unique(base, return_index=True)
    h1, h2 = h1[keep], h2[keep]
    n = max(len(h1), 1)
    block = max(4, int(1.23 * n / 3) + 8)
    for seed in range(100):
        f = _try_build(h1, h2, block, seed * 0x9E3779B1 & 0x7FFFFFFF,
                       fp_bits)
        if f is not None:
            return f
        block = int(block * 1.1) + 1
    raise RuntimeError("xor filter construction failed")
