"""Host reference evaluator: filter trees over native numpy columns (carried over from
knoxdb_tpu/exec/oracle.py).

Dual role, mirroring the reference's generic-Go kernels that back its SIMD
paths (internal/cmp/cmp.go generic fns, used as test
oracles in internal/cmp/avx2/kernel_test.go):
1. evaluates query trees over JOURNAL rows (small, host-resident overlay)
   with semantics bit-identical to the device kernels, and
2. serves as the independent oracle for kernel equivalence tests.

Comparison happens in the keyform integer domain (utils/limbs.py) so
float/total-order/wide-int semantics match the device exactly.
"""

from __future__ import annotations

import numpy as np

from ..query.filter import Filter, Node
from ..types import FieldType, FilterMode
from ..utils import limbs as lb

__all__ = ["eval_tree", "eval_leaf", "column_keys"]


def column_keys(col, ft: FieldType) -> np.ndarray:
    """Native values -> object array of python-int keyform keys."""
    n = len(col)
    if ft.nlimbs <= 2 and not isinstance(col, np.ndarray) or \
            (isinstance(col, np.ndarray) and col.dtype == object and ft.nlimbs <= 2):
        col = np.asarray(list(col), lb.numpy_dtype(ft))
    limbs = lb.to_keyform(col, ft)
    out = np.zeros(n, object)
    for l in range(limbs.shape[0]):
        for i in range(n):
            out[i] = (int(out[i]) << 32) | int(limbs[l, i])
    return out


def eval_leaf(f: Filter, col) -> np.ndarray:
    if f.field.type.is_bytes_like:
        return _eval_bytes(f, col)
    keys = column_keys(col, f.field.type)
    m = f.mode
    if m == FilterMode.TRUE:
        return np.ones(len(keys), bool)
    if m == FilterMode.FALSE:
        return np.zeros(len(keys), bool)
    if m == FilterMode.EQ:
        return keys == f.key
    if m == FilterMode.NE:
        return keys != f.key
    if m == FilterMode.LT:
        return keys < f.key
    if m == FilterMode.LE:
        return keys <= f.key
    if m == FilterMode.GT:
        return keys > f.key
    if m == FilterMode.GE:
        return keys >= f.key
    if m == FilterMode.RANGE:
        return (keys >= f.key) & (keys <= f.key_hi)
    if m in (FilterMode.IN, FilterMode.NOT_IN):
        ks = set(int(k) for k in f.keys)
        inm = np.array([int(k) in ks for k in keys], bool)
        return ~inm if m == FilterMode.NOT_IN else inm
    raise ValueError(f"oracle: unsupported mode {m}")


def _eval_bytes(f: Filter, col) -> np.ndarray:
    """STRING/BYTES leaves: full byte comparison (journal overlay)."""
    vals = [v.encode() if isinstance(v, str) else bytes(v) for v in col]
    m = f.mode
    if m == FilterMode.TRUE:
        return np.ones(len(vals), bool)
    if m == FilterMode.FALSE:
        return np.zeros(len(vals), bool)
    if m == FilterMode.REGEXP:
        rx = f.value_bytes

        def dec(v):
            try:
                return v.decode()
            except UnicodeDecodeError:
                return v.decode("latin-1")
        return np.array([rx.search(dec(v)) is not None for v in vals], bool)
    if m in (FilterMode.IN, FilterMode.NOT_IN):
        want = set(f.value_bytes)
        inm = np.array([v in want for v in vals], bool)
        return ~inm if m == FilterMode.NOT_IN else inm
    c = f.value_bytes
    if m == FilterMode.RANGE:
        lo, hi = c
        return np.array([lo <= v <= hi for v in vals], bool)
    ops = {FilterMode.EQ: lambda v: v == c, FilterMode.NE: lambda v: v != c,
           FilterMode.LT: lambda v: v < c, FilterMode.LE: lambda v: v <= c,
           FilterMode.GT: lambda v: v > c, FilterMode.GE: lambda v: v >= c}
    return np.array([ops[m](v) for v in vals], bool)


def eval_tree(node: Node | None, data: dict, n: int) -> np.ndarray:
    if node is None:
        return np.ones(n, bool)
    if node.is_leaf:
        return eval_leaf(node.filter, data[node.filter.field.name])
    masks = [eval_tree(c, data, n) for c in node.children]
    out = masks[0]
    for m in masks[1:]:
        out = (out | m) if node.or_ else (out & m)
    return out
