"""Predicates over u32 keyform limbs, in PyTorch.

The port of knoxdb_tpu/ops/cmp.py. Every type is in order-preserving
keyform (utils/limbs.py), so one lexicographic unsigned limb comparison
family covers i8..i64, u8..u64, f32, f64, i128, i256, decimals and
timestamps.

All functions take:
  x: int32[L, *shape]  column limbs, int32-carried u32 (ops/words.py),
                       limb 0 most significant (L = 1, 2, 4 or 8)
  c: int32[L]          constant limbs, int32-carried (a tensor on x's
                       device, or any sequence of int32-carried ints)
and return bool[*shape] masks. Torch compares int32 as signed, so both
sides have bit 31 flipped first: x < y as u32 iff (x ^ 2^31) < (y ^ 2^31)
as int32. Equality needs no flip.
"""

from __future__ import annotations

import torch

from ..types import FilterMode

__all__ = ["eq", "ne", "lt", "le", "gt", "ge", "between", "in_set",
           "not_in_set", "match", "lt_vec", "eq_vec", "le_vec"]

_FLIP = -(1 << 31)


def _u(v):
    """An int32-carried u32 limb (tensor or python int) in the signed
    order that equals its unsigned order."""
    return v ^ _FLIP


def eq(x, c):
    m = x[0] == c[0]
    for l in range(1, x.shape[0]):
        m = m & (x[l] == c[l])
    return m


def ne(x, c):
    return ~eq(x, c)


def lt(x, c):
    """Lexicographic unsigned x < c over limbs (limb 0 most significant)."""
    L = x.shape[0]
    m = _u(x[0]) < _u(c[0])
    if L == 1:
        return m
    eq_so_far = x[0] == c[0]
    for l in range(1, L):
        m = m | (eq_so_far & (_u(x[l]) < _u(c[l])))
        if l < L - 1:
            eq_so_far = eq_so_far & (x[l] == c[l])
    return m


def le(x, c):
    L = x.shape[0]
    if L == 1:
        return _u(x[0]) <= _u(c[0])
    m = _u(x[0]) < _u(c[0])
    eq_so_far = x[0] == c[0]
    for l in range(1, L):
        m = m | (eq_so_far & (_u(x[l]) < _u(c[l])))
        eq_so_far = eq_so_far & (x[l] == c[l])
    return m | eq_so_far


def gt(x, c):
    return ~le(x, c)


def ge(x, c):
    return ~lt(x, c)


def between(x, lo, hi):
    """lo <= x <= hi (the RANGE filter mode)."""
    return ge(x, lo) & le(x, hi)


def in_set(x, cs):
    """x in {cs[:, k]}. cs: int32[L, K]; a K-way OR of EQ sweeps, for small
    K (large sets take the sort membership of exec/device.py)."""
    m = eq(x, cs[:, 0])
    for k in range(1, cs.shape[1]):
        m = m | eq(x, cs[:, k])
    return m


def not_in_set(x, cs):
    return ~in_set(x, cs)


# --- column-vs-column comparisons (join keys, sort) ---

def eq_vec(x, y):
    return eq(x, y)


def lt_vec(x, y):
    return lt(x, y)


def le_vec(x, y):
    return ~lt_vec(y, x)


def match(mode: FilterMode, x, lo=None, hi=None, in_limbs=None):
    """Dispatch by filter mode."""
    if mode == FilterMode.EQ:
        return eq(x, lo)
    if mode == FilterMode.NE:
        return ne(x, lo)
    if mode == FilterMode.GT:
        return gt(x, lo)
    if mode == FilterMode.GE:
        return ge(x, lo)
    if mode == FilterMode.LT:
        return lt(x, lo)
    if mode == FilterMode.LE:
        return le(x, lo)
    if mode == FilterMode.RANGE:
        return between(x, lo, hi)
    if mode == FilterMode.IN:
        return in_set(x, in_limbs)
    if mode == FilterMode.NOT_IN:
        return not_in_set(x, in_limbs)
    if mode == FilterMode.TRUE:
        return torch.ones(x.shape[1:], dtype=torch.bool, device=x.device)
    if mode == FilterMode.FALSE:
        return torch.zeros(x.shape[1:], dtype=torch.bool, device=x.device)
    raise ValueError(f"unsupported filter mode {mode!r}")
