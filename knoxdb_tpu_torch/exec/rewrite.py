"""Host-side predicate rewriting: filter leaves -> per-group device consts.

The port of knoxdb_tpu/exec/rewrite.py for the schemes of this slice.
Every constant is related to the packs on the host, where u64 and
python-int arithmetic is exact, and reaches the device as per-plane
select words plus per-pack flags (ops/bitslice.rel_to_device):

- BITPACK (narrow): the keyform constant(s) against each pack's min_key.
- DICT: the predicate rewritten into per-pack CODE space via binary
  search on each pack's sorted dictionary (the device never touches the
  values), then related to the code planes.
- CONST packs: fully decided on the host -> bool verdict per pack.

The other schemes and the dictionary-mask paths (byte IN/NOT_IN/REGEXP,
integer IN lists of 64+ keys) raise NotImplementedError naming their
ROADMAP.md item.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from ..encode.schemes import Scheme
from ..ops import bitslice as B
from ..pack.segment import EncodedColumn
from ..query.filter import Filter
from ..types import FilterMode
from .device import DeviceGroup

__all__ = ["leaf_group_consts", "leaf_group_static"]

_MISS = 1 << 63          # sentinel: outside every packed domain
_IN_DICT_MASK_MIN_K = 64  # from here on the reference takes a dict mask


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


def leaf_group_consts(leaf: Filter, col: EncodedColumn, g: DeviceGroup,
                      device):
    """Device constants for one (leaf, group) on `device`."""
    if g.scheme == Scheme.CONST:
        return {"const_match": torch.from_numpy(
            _const_verdicts(leaf, col, g)).to(device)}
    if g.scheme == Scheme.DICT:
        lo, hi, cs = (_dict_consts_bytes(leaf, g) if g.dict_bytes is not None
                      else _dict_consts(leaf, g))
        min_keys = np.zeros(g.npacks, np.uint64)
    elif g.scheme == Scheme.BITPACK and not g.wide:
        lo, hi, cs = leaf.key, leaf.key_hi, leaf.keys
        min_keys = g.min_keys
    else:
        raise NotImplementedError(
            f"leaf_group_consts: {g.scheme.name} (wide={g.wide}): ROADMAP.md "
            f"queue 1 item 3: DELTA/RLE/RAW/ALP and wide matching")

    def rel(c):
        return B.rel_to_device(B._rel_const(c, min_keys, g.width), g.width,
                               device)

    if leaf.mode == FilterMode.RANGE:
        return {"rel_lo": rel(lo), "rel_hi": rel(hi)}
    if leaf.mode in (FilterMode.IN, FilterMode.NOT_IN):
        return {"rels": [rel(c) for c in cs]}
    return {"rel": rel(lo)}


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


def _dict_mask_todo(leaf: Filter):
    return NotImplementedError(
        f"dictionary-mask matching for {leaf.mode.name} needs the code "
        f"decode: ROADMAP.md queue 1 items 2-3")


def _dict_consts_bytes(leaf: Filter, g: DeviceGroup):
    """STRING/BYTES predicates -> per-pack code space via the byte-sorted
    host dictionaries (exact: the full byte comparison happens on the
    dictionary). Returns (lo u64[P], hi u64[P], None)."""
    m = leaf.mode
    if m in (FilterMode.IN, FilterMode.NOT_IN, FilterMode.REGEXP):
        raise _dict_mask_todo(leaf)
    P = g.npacks
    lo = np.zeros(P, np.uint64)
    hi = np.zeros(P, np.uint64)
    for j, db in enumerate(g.dict_bytes):
        card = len(db)
        if m in (FilterMode.EQ, FilterMode.NE):
            pos = bisect.bisect_left(db, leaf.value_bytes)
            found = pos < card and db[pos] == leaf.value_bytes
            lo[j] = pos if found else _MISS
        elif m in (FilterMode.LT, FilterMode.GE):
            lo[j] = bisect.bisect_left(db, leaf.value_bytes)
        elif m in (FilterMode.LE, FilterMode.GT):
            lo[j] = bisect.bisect_right(db, leaf.value_bytes)
        elif m == FilterMode.RANGE:
            l = bisect.bisect_left(db, leaf.value_bytes[0])
            h = bisect.bisect_right(db, leaf.value_bytes[1])
            if h == 0:
                lo[j], hi[j] = 1, 0
            else:
                lo[j], hi[j] = l, h - 1
        else:
            raise ValueError(f"bytes dict rewrite: {m}")
    return lo, hi, None


def _dict_consts(leaf: Filter, g: DeviceGroup):
    """Rewrite a value-space predicate to per-pack code space.

    Code space is order-preserving (dictionaries are sorted), so:
      EQ v   -> EQ  pos        (or miss sentinel)
      LT v   -> LT  lower_bound(v)
      LE v   -> LT  upper_bound(v)
      GT v   -> GE  upper_bound(v)
      GE v   -> GE  lower_bound(v)
      RANGE  -> RANGE [lower_bound(lo), upper_bound(hi) - 1]
      IN     -> IN  per-pack positions (miss sentinel where absent)
    (the static mode mapping lives in exec/device.group_match).
    Returns (lo u64[P], hi u64[P], cs u64[K, P] or None)."""
    m = leaf.mode
    P = g.npacks
    if m in (FilterMode.IN, FilterMode.NOT_IN):
        keys = np.asarray(leaf.keys, np.uint64)
        if len(keys) >= _IN_DICT_MASK_MIN_K:
            raise _dict_mask_todo(leaf)
        cs = np.full((len(keys), P), _MISS, np.uint64)
        for j, dk in enumerate(g.dict_keys):
            pos = np.searchsorted(dk, keys)
            pos_c = np.minimum(pos, len(dk) - 1)
            found = dk[pos_c] == keys
            cs[:, j] = np.where(found, pos_c, _MISS)
        return None, None, cs

    lo = np.zeros(P, np.uint64)
    hi = np.zeros(P, np.uint64)
    for j, dk in enumerate(g.dict_keys):
        card = len(dk)
        if m in (FilterMode.EQ, FilterMode.NE):
            pos = int(np.searchsorted(dk, np.uint64(leaf.key)))
            found = pos < card and int(dk[pos]) == leaf.key
            lo[j] = pos if found else _MISS
        elif m in (FilterMode.LT, FilterMode.GE):
            lo[j] = np.searchsorted(dk, np.uint64(leaf.key), side="left")
        elif m in (FilterMode.LE, FilterMode.GT):
            lo[j] = np.searchsorted(dk, np.uint64(leaf.key), side="right")
        elif m == FilterMode.RANGE:
            l = int(np.searchsorted(dk, np.uint64(leaf.key), side="left"))
            h = int(np.searchsorted(dk, np.uint64(leaf.key_hi), side="right"))
            if h == 0:
                lo[j], hi[j] = 1, 0       # empty code range
            else:
                lo[j], hi[j] = l, h - 1
        else:
            raise ValueError(f"dict rewrite: {m}")
    return lo, hi, None
