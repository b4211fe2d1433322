"""Compressed row-id sets: roaring-style two-level containers (carried over from
knoxdb_tpu/utils/ridset.py).

Analog of the reference's xroar bitmaps
(internal/xroar/bitmap.go:22-30), which back index query
results and tombstone sets. Same container design, numpy-vectorized:
rids partition by their high 48 bits; each bucket stores its low-16-bit
members either as a sorted u16 ARRAY (sparse, <= _CUTOFF members) or a
2^16-bit BITMAP (dense) — worst case 8 KB per 65536-rid bucket vs
O(total_rows / 8) for a flat positional bitset.

Used by engine/index.PackIndex lookups and the include-mask build
(engine/table._rid_include_masks): a selective index hit on a billion-row
table costs KBs, not 125 MB.
"""

from __future__ import annotations

import numpy as np

__all__ = ["RidSet"]

_CUTOFF = 4096          # array<->bitmap switch (8 KB either way)


class RidSet:
    """Immutable sorted set of u64 row ids in roaring containers."""

    __slots__ = ("_keys", "_containers", "_n")

    def __init__(self, keys, containers, n):
        self._keys = keys               # u64[nb] sorted bucket highs
        self._containers = containers   # per bucket: u16 array | bitmap
        self._n = n

    # ------------------------------------------------------------ build --

    @classmethod
    def from_array(cls, rids: np.ndarray) -> "RidSet":
        rids = np.unique(np.asarray(rids, np.uint64))
        if not len(rids):
            return cls(np.empty(0, np.uint64), [], 0)
        hi = rids >> np.uint64(16)
        lo = rids.astype(np.uint16)
        keys, starts = np.unique(hi, return_index=True)
        bounds = np.append(starts, len(rids))
        containers = []
        for b in range(len(keys)):
            lows = lo[bounds[b]:bounds[b + 1]]
            if len(lows) <= _CUTOFF:
                containers.append(lows.copy())
            else:
                # bitwise_or.at: fancy-indexed |= would drop updates
                # landing on the same word
                bm = np.zeros(1 << 10, np.uint64)       # 2^16 bits
                np.bitwise_or.at(bm, lows.astype(np.int64) >> 6,
                                 np.uint64(1) << (lows.astype(np.uint64)
                                                  & np.uint64(63)))
                containers.append(bm)
        return cls(keys, containers, len(rids))

    @classmethod
    def empty(cls) -> "RidSet":
        return cls(np.empty(0, np.uint64), [], 0)

    # ------------------------------------------------------------- props --

    def __len__(self) -> int:
        return self._n

    @property
    def nbytes(self) -> int:
        return self._keys.nbytes + sum(c.nbytes for c in self._containers)

    def to_array(self) -> np.ndarray:
        """Materialize sorted u64 rids (small sets / tests)."""
        parts = []
        for k, c in zip(self._keys, self._containers):
            base = np.uint64(int(k) << 16)
            if c.dtype == np.uint16:
                parts.append(base + c.astype(np.uint64))
            else:
                bits = np.unpackbits(c.view(np.uint8), bitorder="little")
                parts.append(base + np.flatnonzero(bits).astype(np.uint64))
        return np.concatenate(parts) if parts else np.empty(0, np.uint64)

    # -------------------------------------------------------------- ops --

    def isin(self, rids: np.ndarray) -> np.ndarray:
        """bool[n]: membership of each rid (vectorized per bucket)."""
        rids = np.asarray(rids, np.uint64)
        out = np.zeros(len(rids), bool)
        if not self._n or not len(rids):
            return out
        hi = rids >> np.uint64(16)
        bidx = np.searchsorted(self._keys, hi)
        ok = (bidx < len(self._keys))
        ok[ok] &= self._keys[bidx[ok]] == hi[ok]
        for b in np.unique(bidx[ok]):
            sel = np.flatnonzero(ok & (bidx == b))
            lows = rids[sel].astype(np.uint16)
            c = self._containers[b]
            if c.dtype == np.uint16:
                pos = np.searchsorted(c, lows)
                pos_ok = pos < len(c)
                hit = np.zeros(len(lows), bool)
                hit[pos_ok] = c[pos[pos_ok]] == lows[pos_ok]
            else:
                hit = (c[lows.astype(np.int64) >> 6]
                       >> (lows.astype(np.uint64) & np.uint64(63))) \
                    & np.uint64(1) != 0
            out[sel[hit]] = True
        return out

    def union(self, other: "RidSet") -> "RidSet":
        if not other._n:
            return self
        if not self._n:
            return other
        return RidSet.from_array(
            np.concatenate([self.to_array(), other.to_array()]))

    def intersect_array(self, rids: np.ndarray) -> np.ndarray:
        return np.asarray(rids, np.uint64)[self.isin(rids)]
