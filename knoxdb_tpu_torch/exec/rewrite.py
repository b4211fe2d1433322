"""Host-side predicate rewriting: filter leaves -> per-group device consts.

The port of knoxdb_tpu/exec/rewrite.py. Every constant is related to the
packs on the host, where u64 and python-int arithmetic is exact:

- BITPACK (narrow) and DICT, range-family modes (EQ, LT, LE, GT, GE,
  RANGE): "range" = the ladder kernel's operands (per-plane select words
  and per-pack flag words, ops/scan_kernels.range_consts) of the inclusive
  key range the mode means; for DICT the per-pack CODE range found by
  binary search on each pack's sorted dictionary (the device never touches
  the values).
- BITPACK (narrow) NE and IN lists of fewer than 17 keys, DICT NE and IN
  lists of fewer than 64 keys: per-key relations to each pack's domain
  (ops/bitslice.rel_to_device).
- BITPACK (wide): the same "range" operands and per-key relations, computed
  with python ints against the packs' python-int bases; IN lists of 17+
  keys travel as limbs with the bases for the sort membership.
- BITPACK / DELTA IN lists of 17+ keys: "cs", the keys as int64 u64 bits.
- DICT bytes IN / NOT_IN / REGEXP and integer IN lists of 64+ keys:
  "dict_mask", a bool verdict per dictionary entry.
- DELTA: "lo" / "hi" as order-preserving int64 python ints.
- RLE / RAW: int32-carried u32 limb constants for the limb compare.
- CONST packs: fully decided on the host -> bool verdict per pack.

ALP (decimal-scaled float) packs raise NotImplementedError naming
ROADMAP.md queue 1 item 4.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from ..encode.schemes import Scheme
from ..ops import bitslice as B
from ..ops import scan_kernels as SK
from ..ops import words as WD
from ..pack.segment import EncodedColumn
from ..query.filter import Filter
from ..types import FilterMode
from .device import _IN_SORT_MIN_K, DeviceGroup, base_limbs

__all__ = ["leaf_group_consts", "leaf_group_static"]

_MISS = 1 << 63          # sentinel: outside every packed domain
_IN_DICT_MASK_MIN_K = 64  # from here on a dictionary IN takes a dict mask
_RANGE_MODES = (FilterMode.RANGE, FilterMode.GT, FilterMode.GE,
                FilterMode.LT, FilterMode.LE, FilterMode.EQ)
_TODO_ALP = ("ALP (decimal-scaled float) predicates are not ported yet: "
             "ROADMAP.md queue 1 item 4")


def _pow2_pad(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def leaf_group_static(leaf: Filter, g: DeviceGroup) -> tuple:
    """Static part of the rewrite (goes into the plan signature)."""
    K = 0
    if leaf.mode in (FilterMode.IN, FilterMode.NOT_IN):
        K = _pow2_pad(len(leaf.keys))
    mask_path = g.dict_bytes is not None and leaf.mode in (
        FilterMode.IN, FilterMode.NOT_IN, FilterMode.REGEXP)
    return (int(leaf.mode), int(g.scheme), g.width, g.nlimbs, g.wide, K,
            mask_path)


def _range_ops(min_keys, lo, hi, width: int, device):
    return tuple(WD.to_words(a, device)
                 for a in SK.range_consts(min_keys, lo, hi, width))


def leaf_group_consts(leaf: Filter, col: EncodedColumn, g: DeviceGroup,
                      device):
    """Device constants for one (leaf, group) on `device`."""
    mode = leaf.mode
    is_in = mode in (FilterMode.IN, FilterMode.NOT_IN)
    if g.scheme == Scheme.CONST:
        return {"const_match": torch.from_numpy(
            _const_verdicts(leaf, col, g)).to(device)}
    if g.scheme == Scheme.ALP:
        return _alp_consts(leaf, g)

    if g.scheme == Scheme.DICT:
        if mode in _RANGE_MODES:
            lo_a, hi_a = _dict_code_range_host(leaf, g)
            return {"range": _range_ops(np.zeros(g.npacks, np.uint64), lo_a,
                                        hi_a, g.width, device)}
        got = (_dict_consts_bytes(leaf, g) if g.dict_bytes is not None
               else _dict_consts(leaf, g))
        if isinstance(got, np.ndarray):
            return {"dict_mask": torch.from_numpy(got).to(device)}
        lo, hi, cs = got
        min_keys = np.zeros(g.npacks, np.uint64)
    elif g.scheme in (Scheme.BITPACK, Scheme.DELTA) and g.wide:
        return _wide_bitpack_consts(leaf, g, device)
    elif g.scheme == Scheme.BITPACK:
        if mode in _RANGE_MODES:
            lo_v, hi_v = _mode_to_range_host(
                mode, int(leaf.key), int(getattr(leaf, "key_hi", 0) or 0))
            return {"range": _range_ops(g.min_keys, np.uint64(lo_v),
                                        np.uint64(hi_v), g.width, device)}
        if is_in and _pow2_pad(len(leaf.keys)) >= _IN_SORT_MIN_K:
            return {"cs": _key_bits(_pad_keys(leaf.keys), device)}
        lo, hi, cs = leaf.key, leaf.key_hi, leaf.keys
        min_keys = g.min_keys
    elif g.scheme == Scheme.DELTA:
        if is_in:
            return {"cs": _key_bits(_pad_keys(leaf.keys), device)}
        out = {"lo": int(WD.ordered_from_u64(leaf.key))}
        if mode == FilterMode.RANGE:
            out["hi"] = int(WD.ordered_from_u64(leaf.key_hi))
        return out
    else:
        # RAW / RLE: limb-domain constants
        if is_in:
            limbs = leaf.key_limbs
            K = _pow2_pad(limbs.shape[1])
            pad = np.repeat(limbs[:, :1], K - limbs.shape[1], axis=1)
            return {"cs_limbs": WD.to_words(
                np.concatenate([limbs, pad], axis=1), device)}
        out = {"lo_limbs": WD.to_words(_int_to_limbs(leaf.key, g.nlimbs),
                                       device)}
        if mode == FilterMode.RANGE:
            out["hi_limbs"] = WD.to_words(
                _int_to_limbs(leaf.key_hi, g.nlimbs), device)
        return out

    def rel(c):
        return B.rel_to_device(B._rel_const(c, min_keys, g.width), g.width,
                               device)

    if is_in:
        return {"rels": [rel(c) for c in cs]}
    return {"rel": rel(lo)}


def _key_bits(keys: np.ndarray, device) -> torch.Tensor:
    """u64 keys -> int64 tensor with the same bits."""
    return torch.from_numpy(WD.bits_from_u64(keys)).to(device)


def _int_to_limbs(key: int, L: int) -> np.ndarray:
    out = np.empty(L, np.uint32)
    for l in range(L - 1, -1, -1):
        out[l] = key & 0xFFFFFFFF
        key >>= 32
    return out


def _pad_keys(keys: np.ndarray) -> np.ndarray:
    """IN keys padded to the next power of two with repeats of the first."""
    K = _pow2_pad(len(keys))
    if K == len(keys):
        return keys.astype(np.uint64)
    pad = np.repeat(keys[:1], K - len(keys))
    return np.concatenate([keys, pad]).astype(np.uint64)


def _pack_const_value(col: EncodedColumn, g: DeviceGroup, j: int) -> int:
    """Python-int key of a CONST pack (wide bases included)."""
    if g.wide:
        return g.bases[j]
    p = col.packs[int(g.idx[j])]
    x = 0
    for l in range(p.values.shape[0]):
        x = (x << 32) | int(p.values[l, 0])
    return x


def _const_verdicts(leaf: Filter, col: EncodedColumn, g: DeviceGroup) -> np.ndarray:
    out = np.empty(g.npacks, bool)
    m = leaf.mode
    for j in range(g.npacks):
        v = _pack_const_value(col, g, j)
        if m == FilterMode.EQ:
            out[j] = v == leaf.key
        elif m == FilterMode.NE:
            out[j] = v != leaf.key
        elif m == FilterMode.LT:
            out[j] = v < leaf.key
        elif m == FilterMode.LE:
            out[j] = v <= leaf.key
        elif m == FilterMode.GT:
            out[j] = v > leaf.key
        elif m == FilterMode.GE:
            out[j] = v >= leaf.key
        elif m == FilterMode.RANGE:
            out[j] = leaf.key <= v <= leaf.key_hi
        elif m == FilterMode.IN:
            out[j] = v in set(int(k) for k in leaf.keys)
        elif m == FilterMode.NOT_IN:
            out[j] = v not in set(int(k) for k in leaf.keys)
        else:
            raise ValueError(f"const verdict: {m}")
    return out


def _dict_code_range_host(leaf, g):
    """Per-pack inclusive CODE ranges for a DICT-group leaf of the fused
    kernel and of the ladder kernel that serves the rest mask. Dictionaries
    are sorted, so EQ/LT/LE/GT/GE/RANGE map to half-open code intervals
    via bisect. Empty intervals (incl. EQ misses) encode as the inverted
    pair (1, 0): the ladders then require code >= 1 AND code <= 0, which
    no row satisfies. Returns (lo u64[P], hi u64[P])."""
    P = g.npacks
    lo = np.zeros(P, np.uint64)
    hi = np.zeros(P, np.uint64)
    m = leaf.mode
    is_bytes = g.dict_bytes is not None
    for j in range(P):
        if is_bytes:
            dk = g.dict_bytes[j]
            v = leaf.value_bytes
            v0, v1 = (v[0], v[1]) if m == FilterMode.RANGE else (v, v)
            lb_ = lambda x: bisect.bisect_left(dk, x)      # noqa: E731
            ub_ = lambda x: bisect.bisect_right(dk, x)     # noqa: E731
        else:
            dk = g.dict_keys[j]
            v0 = np.uint64(int(leaf.key))
            v1 = np.uint64(int(getattr(leaf, "key_hi", 0) or 0)) \
                if m == FilterMode.RANGE else v0
            lb_ = lambda x: int(np.searchsorted(dk, x, "left"))   # noqa: E731
            ub_ = lambda x: int(np.searchsorted(dk, x, "right"))  # noqa: E731
        card = len(dk)
        if m == FilterMode.EQ:
            l, h = lb_(v0), ub_(v0)            # [pos, pos+1) or empty
        elif m == FilterMode.LT:
            l, h = 0, lb_(v0)
        elif m == FilterMode.LE:
            l, h = 0, ub_(v0)
        elif m == FilterMode.GT:
            l, h = ub_(v0), card
        elif m == FilterMode.GE:
            l, h = lb_(v0), card
        elif m == FilterMode.RANGE:
            l, h = lb_(v0), ub_(v1)
        else:
            raise ValueError(f"_dict_code_range_host: {m}")
        if h <= l:
            lo[j], hi[j] = 1, 0                # universally empty
        else:
            lo[j], hi[j] = l, h - 1
    return lo, hi


def _mode_to_range_host(mode: FilterMode, lo: int, hi: int):
    """Inclusive u64 (lo, hi) of a fusable mode. Strict modes adjust by one
    key; boundary wraps (GT u64max, LT 0) map to the universally-empty
    range (1, 0)."""
    U = (1 << 64) - 1
    if mode == FilterMode.RANGE:
        return lo, hi
    if mode == FilterMode.EQ:
        return lo, lo
    if mode == FilterMode.GE:
        return lo, U
    if mode == FilterMode.LE:
        return 0, lo
    if mode == FilterMode.GT:
        return (1, 0) if lo == U else (lo + 1, U)
    if mode == FilterMode.LT:
        return (1, 0) if lo == 0 else (0, lo - 1)
    raise ValueError(f"_mode_to_range_host: {mode}")


# ---------------------------------------------------------------- alp ---

def _alp_keybound(key: int, ft) -> float:
    raise NotImplementedError(_TODO_ALP)


def _alp_consts(leaf: Filter, g: DeviceGroup):
    raise NotImplementedError(f"leaf_group_consts: {_TODO_ALP}")


# --------------------------------------------------------------- wide ---

def _wide_rel(c: int, bases: list[int], width: int):
    """Exact python-int domain relation of one constant for wide BITPACK
    groups: numpy (c_rel u64[P], lt_all, ge_none, in_dom bool[P])."""
    return _wide_rel_list([c] * len(bases), bases, width)


def _wide_rel_list(cs: list[int], bases: list[int], width: int):
    """_wide_rel with one constant per pack (exact python ints)."""
    maxp = (1 << width) - 1
    P = len(bases)
    c_rel = np.zeros(P, np.uint64)
    lt_all = np.zeros(P, bool)
    ge_none = np.zeros(P, bool)
    in_dom = np.zeros(P, bool)
    for j, (c, b) in enumerate(zip(cs, bases)):
        d = c - b
        if d < 0:
            ge_none[j] = True
        elif d > maxp:
            lt_all[j] = True
        else:
            in_dom[j] = True
            c_rel[j] = d
    return c_rel, lt_all, ge_none, in_dom


def _wide_bitpack_consts(leaf: Filter, g: DeviceGroup, device):
    m = leaf.mode

    def rel(c):
        return B.rel_to_device(_wide_rel(c, g.bases, g.width), g.width,
                               device)

    if g.scheme == Scheme.BITPACK and m in _RANGE_MODES:
        # the ladder kernel's operands, as narrow groups get them: the
        # bounds relate to each pack's python-int base exactly, and an open
        # side (None) lies outside every pack's domain
        P = g.npacks
        z = np.zeros(P, np.uint64)
        no, yes = np.zeros(P, bool), np.ones(P, bool)
        below, above = (z, no, yes, no), (z, yes, no, no)
        key = int(leaf.key)
        lo, hi = {FilterMode.RANGE: (key, leaf.key_hi),
                  FilterMode.EQ: (key, key),
                  FilterMode.GE: (key, None), FilterMode.GT: (key + 1, None),
                  FilterMode.LE: (None, key),
                  FilterMode.LT: (None, key - 1)}[m]
        rel_lo, rel_hi = (
            side if c is None else _wide_rel(int(c), g.bases, g.width)
            for c, side in ((lo, below), (hi, above)))
        return {"range": tuple(
            WD.to_words(a, device)
            for a in SK.range_consts_rel(rel_lo, rel_hi, g.width))}
    if m in (FilterMode.IN, FilterMode.NOT_IN):
        if g.scheme == Scheme.BITPACK and len(leaf.keys) >= _IN_SORT_MIN_K:
            # big wide IN list: the keys as limbs and the packs' bases for
            # the absolute rebase; the device decodes, rebases and runs one
            # merged (L+1)-key sort
            limbs = leaf.key_limbs
            K = _pow2_pad(limbs.shape[1])
            pad = np.repeat(limbs[:, :1], K - limbs.shape[1], axis=1)
            return {"cs_limbs": WD.to_words(
                        np.concatenate([limbs, pad], axis=1), device),
                    "base_limbs": WD.to_words(base_limbs(g.bases, g.nlimbs),
                                              device)}
        keys = [int(k) for k in leaf.keys]
        keys = keys + [keys[0]] * (_pow2_pad(len(keys)) - len(keys))
        return {"rels": [rel(k) for k in keys]}
    return {"rel": rel(leaf.key)}


# -------------------------------------------------------------- bytes ---

def _dict_consts_bytes(leaf: Filter, g: DeviceGroup):
    """STRING/BYTES predicates -> per-pack code space via the byte-sorted
    host dictionaries (exact: the full byte comparison happens on the
    dictionary), for the modes that do not become code ranges
    (_dict_code_range_host). IN / NOT_IN / REGEXP give a bool dict mask
    [P, k], gathered by code on the device; NE gives (pos u64[P] or the
    miss sentinel, None, None)."""
    m = leaf.mode
    P = g.npacks
    if m in (FilterMode.IN, FilterMode.NOT_IN, FilterMode.REGEXP):
        dm = np.zeros((P, g.k), bool)
        for j, db in enumerate(g.dict_bytes):
            if m == FilterMode.REGEXP:
                rx = leaf.value_bytes
                for c, b in enumerate(db):
                    try:
                        s = b.decode()
                    except UnicodeDecodeError:
                        s = b.decode("latin-1")
                    dm[j, c] = rx.search(s) is not None
            else:
                want = set(leaf.value_bytes)
                for c, b in enumerate(db):
                    dm[j, c] = b in want
        return ~dm if m == FilterMode.NOT_IN else dm
    if m != FilterMode.NE:
        raise ValueError(f"bytes dict rewrite: {m}")
    lo = np.zeros(P, np.uint64)
    for j, db in enumerate(g.dict_bytes):
        pos = bisect.bisect_left(db, leaf.value_bytes)
        found = pos < len(db) and db[pos] == leaf.value_bytes
        lo[j] = pos if found else _MISS
    return lo, None, None


def _dict_consts(leaf: Filter, g: DeviceGroup):
    """Rewrite a value-space predicate to per-pack code space, for the
    modes that do not become code ranges (_dict_code_range_host):

      NE v   -> NE  pos        (or miss sentinel)
      IN     -> IN  per-pack positions (miss sentinel where absent);
                from 64 keys on, a bool dict mask [P, k] instead
    Returns the dict mask, or (lo u64[P], None, cs u64[K, P] or None)."""
    m = leaf.mode
    P = g.npacks
    if m in (FilterMode.IN, FilterMode.NOT_IN):
        keys = np.asarray(leaf.keys, np.uint64)
        if len(keys) >= _IN_DICT_MASK_MIN_K:
            dm = np.zeros((P, g.k), bool)
            for j, dk in enumerate(g.dict_keys):
                dm[j, :len(dk)] = np.isin(dk, keys)
            return ~dm if m == FilterMode.NOT_IN else dm
        cs = np.full((len(keys), P), _MISS, np.uint64)
        for j, dk in enumerate(g.dict_keys):
            pos = np.searchsorted(dk, keys)
            pos_c = np.minimum(pos, len(dk) - 1)
            found = dk[pos_c] == keys
            cs[:, j] = np.where(found, pos_c, _MISS)
        return None, None, cs
    if m != FilterMode.NE:
        raise ValueError(f"dict rewrite: {m}")
    lo = np.zeros(P, np.uint64)
    for j, dk in enumerate(g.dict_keys):
        pos = int(np.searchsorted(dk, np.uint64(leaf.key)))
        found = pos < len(dk) and int(dk[pos]) == leaf.key
        lo[j] = pos if found else _MISS
    return lo, None, None
