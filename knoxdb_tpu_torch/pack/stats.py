"""Zone-map statistics + pack pruning (carried over from
knoxdb_tpu/pack/stats.py).

Stats live as struct-of-arrays per segment (min_key[P], max_key[P] per
column, plus optional stacked bloom filters), and a filter leaf is
pruned against all packs at once. Pruning yields a tri-state per pack:
NONE (no row can match), ALL (every row matches) or MAYBE (evaluate).

Keys are the order-preserving keyform image (utils/limbs.py): u64 arrays
for types up to 64 bits, python-int object arrays for 128/256-bit types.
Strings prune on their 8-byte prefix key.

The BFUSE and BITS pack filters (knoxdb_tpu/filter/fuse.py,
knoxdb_tpu/utils/ridset.py) are not ported yet (ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..filter import bloom
from ..types import FilterMode, FilterType

__all__ = ["FieldStats", "SegmentStats", "TriState", "prune_leaf"]


@dataclass
class TriState:
    """Per-pack prune decision vectors."""
    all_: np.ndarray    # bool[P] every row matches
    none: np.ndarray    # bool[P] no row matches

    @property
    def maybe(self) -> np.ndarray:
        return ~(self.all_ | self.none)

    @staticmethod
    def unknown(P: int) -> "TriState":
        return TriState(np.zeros(P, bool), np.zeros(P, bool))

    def and_(self, o: "TriState") -> "TriState":
        return TriState(self.all_ & o.all_, self.none | o.none)

    def or_(self, o: "TriState") -> "TriState":
        return TriState(self.all_ | o.all_, self.none & o.none)

    def invert(self) -> "TriState":
        return TriState(self.none, self.all_)


@dataclass
class FieldStats:
    """Per-column per-pack zone map (+ optional bloom filter)."""
    min_key: np.ndarray          # u64[P] or object[P] python ints (wide)
    max_key: np.ndarray
    bloom_words: np.ndarray | None = None   # u32[P, words] (bloom kinds)
    filter_type: FilterType = FilterType.NONE
    # True for STRING/BYTES prefix keys: equal prefixes cannot decide, so
    # pruning must use STRICT compares and never emit ALL verdicts
    is_prefix: bool = False
    # lazily-built coarse level (see coarse()); not serialized
    _coarse: tuple | None = field(default=None, repr=False, compare=False)

    def coarse(self) -> tuple:
        """(cmin, cmax) per _TREE_BLOCK-pack super-block: a two-level
        stats tree. Lazily built, cached."""
        if self._coarse is None:
            P = len(self.min_key)
            nb = -(-P // _TREE_BLOCK)
            cmin = np.empty(nb, self.min_key.dtype)
            cmax = np.empty(nb, self.max_key.dtype)
            for b in range(nb):
                s = b * _TREE_BLOCK
                e = min(P, s + _TREE_BLOCK)
                cmin[b] = self.min_key[s:e].min()
                cmax[b] = self.max_key[s:e].max()
            self._coarse = (cmin, cmax)
        return self._coarse

    @classmethod
    def from_packs(cls, pack_keys: list[np.ndarray], wide: bool,
                   limbs_per_pack: list[np.ndarray] | None = None,
                   filter_type: FilterType = FilterType.NONE,
                   pack_capacity: int = 0) -> "FieldStats":
        """pack_keys: per-pack u64 key arrays (or object ints when wide)."""
        P = len(pack_keys)
        dt = object if wide else np.uint64
        mn = np.empty(P, dt)
        mx = np.empty(P, dt)
        for p, k in enumerate(pack_keys):
            mn[p] = k.min() if len(k) else (0 if not wide else 0)
            mx[p] = k.max() if len(k) else (0 if not wide else 0)
        bw = None
        if filter_type.is_bloom:
            nbits = bloom.bloom_bits(pack_capacity or max(len(k) for k in pack_keys),
                                     filter_type)
            bw = np.zeros((P, nbits // 32), np.uint32)
            for p in range(P):
                bw[p] = bloom.build_np(limbs_per_pack[p], nbits)
        elif filter_type.is_fuse or filter_type == FilterType.BITS:
            raise NotImplementedError(
                f"pack filter {filter_type.name} is not ported yet "
                f"(ROADMAP.md queue 1 item 12: filter/fuse.py, utils/ridset.py)")
        elif filter_type != FilterType.NONE:
            raise ValueError(f"unknown pack filter kind {filter_type!r}")
        return cls(mn, mx, bw, filter_type)


@dataclass
class SegmentStats:
    nrows: np.ndarray                       # i64[P]
    rid_base: np.ndarray                    # u64[P] first rid of each pack
    fields: dict[str, FieldStats] = field(default_factory=dict)

    @property
    def npacks(self) -> int:
        return len(self.nrows)


def _aux_none(fs: FieldStats, key_limbs: np.ndarray) -> np.ndarray:
    """bool[P]: the pack's bloom filter proves none of the probed keys
    (`key_limbs` u32[L, K]) is in pack p."""
    P = len(fs.min_key)
    out = np.zeros(P, bool)
    if fs.bloom_words is not None:
        for p in range(P):
            out[p] = not bloom.contains_np(fs.bloom_words[p],
                                           key_limbs).any()
    return out


def _aux_none_bytes(fs: FieldStats, vals: list) -> np.ndarray:
    P = len(fs.min_key)
    out = np.zeros(P, bool)
    if fs.bloom_words is not None:
        for p in range(P):
            out[p] = not bloom.contains_bytes_np(fs.bloom_words[p],
                                                 vals).any()
    return out


_TREE_BLOCK = 2048      # super-block fanout
_TREE_MODES = (FilterMode.EQ, FilterMode.NE, FilterMode.LT, FilterMode.LE,
               FilterMode.GT, FilterMode.GE, FilterMode.RANGE,
               FilterMode.IN, FilterMode.NOT_IN)


def _prune_tree(fs: FieldStats, mode: FilterMode, lo, hi, keys,
                key_limbs, key_bytes) -> TriState:
    """Two-level prune: decide whole super-blocks from (cmin, cmax)
    first — a block decided ALL/NONE covers every pack without touching
    its fine zone maps or blooms (the per-pack bloom probes are python
    loops; at 100k packs they dominate the flat path) — then run the
    flat prune only on MIXED blocks' slices."""
    cmin, cmax = fs.coarse()
    cfs = FieldStats(cmin, cmax, None, FilterType.NONE,
                     is_prefix=fs.is_prefix)
    ct = prune_leaf(cfs, mode, lo, hi, keys, None, None)
    P = len(fs.min_key)
    all_ = np.zeros(P, bool)
    none = np.zeros(P, bool)
    for b in np.flatnonzero(ct.all_):
        all_[b * _TREE_BLOCK:(b + 1) * _TREE_BLOCK] = True
    for b in np.flatnonzero(ct.none):
        none[b * _TREE_BLOCK:(b + 1) * _TREE_BLOCK] = True
    for b in np.flatnonzero(ct.maybe):
        s = b * _TREE_BLOCK
        e = min(P, s + _TREE_BLOCK)
        sub = FieldStats(fs.min_key[s:e], fs.max_key[s:e],
                         None if fs.bloom_words is None
                         else fs.bloom_words[s:e],
                         fs.filter_type, is_prefix=fs.is_prefix)
        t = prune_leaf(sub, mode, lo, hi, keys, key_limbs, key_bytes)
        all_[s:e] = t.all_
        none[s:e] = t.none
    return TriState(all_, none)


def prune_leaf(fs: FieldStats, mode: FilterMode, lo=None, hi=None,
               keys=None, key_limbs=None, key_bytes=None) -> TriState:
    """Tri-state prune of one filter leaf against all packs.

    lo/hi/keys are keyform integers (python int / u64; 8-byte prefixes for
    strings); key_limbs is the u32[L, K] limb form of IN/EQ keys for bloom
    probes; key_bytes the byte values for string blooms."""
    mn, mx = fs.min_key, fs.max_key
    P = len(mn)
    if P >= 2 * _TREE_BLOCK and mode in _TREE_MODES:
        return _prune_tree(fs, mode, lo, hi, keys, key_limbs, key_bytes)
    if key_bytes is not None:
        key_limbs = None     # string blooms hash full bytes

    if mode == FilterMode.TRUE:
        return TriState(np.ones(P, bool), np.zeros(P, bool))
    if mode == FilterMode.FALSE:
        return TriState(np.zeros(P, bool), np.ones(P, bool))

    Z = np.zeros(P, bool)

    if mode in (FilterMode.EQ, FilterMode.NE):
        c = lo
        none = (np.less(mx, c) | np.greater(mn, c))
        if key_limbs is not None:
            none = none | _aux_none(fs, key_limbs)
        if key_bytes is not None:
            none = none | _aux_none_bytes(fs, key_bytes)
        all_ = Z if fs.is_prefix else (np.equal(mn, c) & np.equal(mx, c))
        t = TriState(all_, none)
        return t.invert() if mode == FilterMode.NE else t

    if mode == FilterMode.LT:
        return TriState(Z if fs.is_prefix else np.less(mx, lo),
                        np.greater(mn, lo) if fs.is_prefix
                        else np.greater_equal(mn, lo))
    if mode == FilterMode.LE:
        return TriState(Z if fs.is_prefix else np.less_equal(mx, lo),
                        np.greater(mn, lo))
    if mode == FilterMode.GT:
        return TriState(Z if fs.is_prefix else np.greater(mn, lo),
                        np.less(mx, lo) if fs.is_prefix
                        else np.less_equal(mx, lo))
    if mode == FilterMode.GE:
        return TriState(Z if fs.is_prefix else np.greater_equal(mn, lo),
                        np.less(mx, lo))

    if mode == FilterMode.RANGE:
        all_ = Z if fs.is_prefix else \
            (np.less_equal(lo, mn) & np.less_equal(mx, hi))
        none = np.less(mx, lo) | np.greater(mn, hi)
        return TriState(all_, none)

    if mode in (FilterMode.IN, FilterMode.NOT_IN):
        ks = np.asarray(keys)
        # none: every key outside [min, max] (vectorized over packs x keys)
        inside = (np.less_equal.outer(mn, ks) & np.greater_equal.outer(mx, ks))
        none = ~inside.any(axis=1)
        if key_limbs is not None:
            none = none | _aux_none(fs, key_limbs)
        if key_bytes is not None:
            none = none | _aux_none_bytes(fs, key_bytes)
        # all: single-value pack whose value is in the set
        if fs.is_prefix:
            all_ = np.zeros(P, bool)
        else:
            single = np.equal(mn, mx)
            all_ = single & inside.any(axis=1) & np.isin(mn, ks)
        t = TriState(all_, none)
        return t.invert() if mode == FilterMode.NOT_IN else t

    # REGEXP and friends: cannot prune
    return TriState.unknown(P)
