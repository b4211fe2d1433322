"""Filter condition tree: construction, normalization, optimization
(carried over from knoxdb_tpu/query/filter.py).

Tree invariants after `optimize()`:
- no nested single-child nodes; AND/OR children flattened
- per-field GE/LE/GT/LT pairs under AND merged into RANGE
- EQ lists under OR on one field merged into IN
- constant TRUE/FALSE leaves short-circuited
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np

from ..schema.schema import Field
from ..types import FieldType, FilterMode
from ..utils import limbs as lb

__all__ = ["Filter", "Node", "and_", "or_", "leaf"]


@dataclass
class Filter:
    """One predicate leaf bound to a schema field."""
    field: Field
    mode: FilterMode
    value: Any = None          # EQ..LE: scalar; RANGE: (lo, hi); IN: list
    # keyform image(s), filled by bind():
    key: int | None = None             # python int keyform (scalar modes)
    key_hi: int | None = None          # RANGE upper
    keys: np.ndarray | None = None     # IN/NOT_IN sorted u64 (narrow) / obj
    key_limbs: np.ndarray | None = None  # u32[L, K] for bloom/IN kernels

    value_bytes: object = None         # bytes / (lo, hi) / sorted list

    def bind(self) -> "Filter":
        ft = self.field.type
        m = self.mode
        if m in (FilterMode.TRUE, FilterMode.FALSE):
            return self
        if ft.is_bytes_like:
            return self._bind_bytes()
        if m == FilterMode.REGEXP:
            raise ValueError("REGEXP only applies to string/bytes fields")
        if m == FilterMode.RANGE:
            lo, hi = self.value
            self.key = _key_int(lo, ft)
            self.key_hi = _key_int(hi, ft)
        elif m in (FilterMode.IN, FilterMode.NOT_IN):
            # normalize any iterable (set/generator/tuple) like the old
            # list(self.value) path did; arrays pass through untouched.
            # Reassigned so weight/repr see a sized value afterwards.
            vals = self.value if isinstance(self.value, np.ndarray) \
                else list(self.value)
            self.value = vals
            if not len(vals):
                self.mode = (FilterMode.FALSE if m == FilterMode.IN
                             else FilterMode.TRUE)
                return self
            if ft.nlimbs <= 2:
                # vectorized keyform: a 262k-pk update spent 3.2 s in
                # per-key scalar_to_keyform calls
                from ..encode.schemes import _key_to_limbs
                keys = np.sort(lb.to_keys64(vals, ft))
                self.keys = keys
                self.key_limbs = _key_to_limbs(keys, ft.nlimbs)
            else:
                keys = sorted(_key_int(v, ft) for v in vals)
                self.keys = np.array(keys, object)
                self.key_limbs = _keys_to_limbs(keys, ft)
        else:
            self.key = _key_int(self.value, ft)
            self.key_limbs = _keys_to_limbs([self.key], ft)
        return self

    def _bind_bytes(self) -> "Filter":
        """STRING/BYTES leaves: normalize to bytes, derive 8-byte prefix
        keys for zone-map pruning (strict-only, stats.is_prefix)."""
        from ..encode.schemes import _prefix_key
        m = self.mode

        def nb(v):
            return v.encode() if isinstance(v, str) else bytes(v)

        if m == FilterMode.RANGE:
            lo, hi = self.value
            self.value_bytes = (nb(lo), nb(hi))
            self.key = _prefix_key(self.value_bytes[0])
            self.key_hi = _prefix_key(self.value_bytes[1])
        elif m in (FilterMode.IN, FilterMode.NOT_IN):
            vals = sorted(nb(v) for v in self.value)
            if not vals:
                self.mode = (FilterMode.FALSE if m == FilterMode.IN
                             else FilterMode.TRUE)
                return self
            self.value_bytes = vals
            self.keys = np.array([_prefix_key(v) for v in vals], np.uint64)
        elif m == FilterMode.REGEXP:
            import re
            self.value_bytes = re.compile(
                self.value if isinstance(self.value, str)
                else self.value.decode())
        else:
            self.value_bytes = nb(self.value)
            self.key = _prefix_key(self.value_bytes)
        return self

    @property
    def weight(self) -> int:
        """Relative evaluation cost for tree reordering (reference
        optimize.go orders cheap/selective leaves first)."""
        base = {FilterMode.EQ: 1, FilterMode.NE: 2, FilterMode.GT: 1,
                FilterMode.GE: 1, FilterMode.LT: 1, FilterMode.LE: 1,
                FilterMode.RANGE: 2, FilterMode.TRUE: 0, FilterMode.FALSE: 0,
                FilterMode.REGEXP: 100}.get(self.mode, 4)
        if self.mode in (FilterMode.IN, FilterMode.NOT_IN):
            base = 2 + len(self.value)
        return base * self.field.type.nlimbs

    def __repr__(self):
        return f"{self.field.name}{self.mode.symbol}{self.value!r}"


def _key_int(v, ft: FieldType) -> int:
    limbs = lb.scalar_to_keyform(v, ft)
    x = 0
    for l in limbs:
        x = (x << 32) | l
    return x


def _keys_to_limbs(keys: list[int], ft: FieldType) -> np.ndarray:
    L = ft.nlimbs
    out = np.empty((L, len(keys)), np.uint32)
    for i, k in enumerate(keys):
        for l in range(L - 1, -1, -1):
            out[l, i] = k & 0xFFFFFFFF
            k >>= 32
    return out


@dataclass
class Node:
    """AND/OR tree node; leaf nodes carry a Filter."""
    or_: bool = False
    children: list["Node"] = dc_field(default_factory=list)
    filter: Filter | None = None

    @property
    def is_leaf(self) -> bool:
        return self.filter is not None

    @property
    def is_empty(self) -> bool:
        return not self.children and self.filter is None

    def fields(self) -> set[str]:
        if self.is_leaf:
            return {self.filter.field.name}
        out: set[str] = set()
        for c in self.children:
            out |= c.fields()
        return out

    def leaves(self):
        if self.is_leaf:
            yield self.filter
        for c in self.children:
            yield from c.leaves()

    def optimize(self) -> "Node":
        n = _flatten(self)
        n = _merge_ranges(n)
        n = _short_circuit(n)
        return n

    def __repr__(self):
        if self.is_leaf:
            return repr(self.filter)
        op = " OR " if self.or_ else " AND "
        return "(" + op.join(map(repr, self.children)) + ")"


def leaf(f: Filter) -> Node:
    return Node(filter=f.bind())


def and_(*nodes: Node) -> Node:
    return Node(or_=False, children=list(nodes))


def or_(*nodes: Node) -> Node:
    return Node(or_=True, children=list(nodes))


def _flatten(n: Node) -> Node:
    if n.is_leaf:
        return n
    kids = []
    for c in n.children:
        c = _flatten(c)
        if c.is_empty:
            continue
        if not c.is_leaf and (c.or_ == n.or_ or len(c.children) == 1):
            kids.extend(c.children)
        else:
            kids.append(c)
    if len(kids) == 1:
        return kids[0]
    return Node(or_=n.or_, children=kids)


def _merge_ranges(n: Node) -> Node:
    """AND: per-field lower+upper bound pairs -> RANGE; OR: EQ -> IN."""
    if n.is_leaf:
        return n
    n = Node(or_=n.or_, children=[_merge_ranges(c) for c in n.children])
    byfield: dict[str, list[Node]] = {}
    rest: list[Node] = []
    for c in n.children:
        if c.is_leaf:
            byfield.setdefault(c.filter.field.name, []).append(c)
        else:
            rest.append(c)

    merged: list[Node] = []
    for fname, group in byfield.items():
        if len(group) == 1:
            merged.extend(group)
            continue
        if not n.or_:
            merged.extend(_merge_and_bounds(group))
        else:
            merged.extend(_merge_or_eqs(group))
    return Node(or_=n.or_, children=merged + rest)


def _merge_and_bounds(group: list[Node]) -> list[Node]:
    fld0 = group[0].filter.field
    if fld0.type.is_bytes_like:
        # prefix keys are not exact; leave byte-range leaves unmerged
        return group
    max_key = (1 << fld0.type.bits) - 1
    lo = None   # (key, value, strict)
    hi = None
    out = []
    for g in group:
        f = g.filter
        if f.mode in (FilterMode.GT, FilterMode.GE):
            k = f.key + 1 if f.mode == FilterMode.GT else f.key
            if k > max_key:     # GT type-max -> empty
                return out + [leaf(Filter(fld0, FilterMode.FALSE))]
            v = f.value
            if lo is None or k > lo[0]:
                lo = (k, v, f.mode == FilterMode.GT)
        elif f.mode in (FilterMode.LT, FilterMode.LE):
            k = f.key - 1 if f.mode == FilterMode.LT else f.key
            if k < 0:           # LT type-min -> empty
                return out + [leaf(Filter(fld0, FilterMode.FALSE))]
            v = f.value
            if hi is None or k < hi[0]:
                hi = (k, v, f.mode == FilterMode.LT)
        elif f.mode == FilterMode.RANGE:
            if lo is None or f.key > lo[0]:
                lo = (f.key, f.value[0], False)
            if hi is None or f.key_hi < hi[0]:
                hi = (f.key_hi, f.value[1], False)
        else:
            out.append(g)
            continue
    fld = group[0].filter.field
    if lo is not None and hi is not None:
        if lo[0] > hi[0]:
            nf = Filter(fld, FilterMode.FALSE)
            return out + [leaf(nf)]
        nf = Filter(fld, FilterMode.RANGE, (lo[1], hi[1]))
        nf.bind()
        nf.key, nf.key_hi = lo[0], hi[0]   # exact merged keyform bounds
        return out + [leaf_prebound(nf)]
    if lo is not None:
        nf = Filter(fld, FilterMode.GE, lo[1])
        nf.bind()
        nf.key = lo[0]
        return out + [leaf_prebound(nf)]
    if hi is not None:
        nf = Filter(fld, FilterMode.LE, hi[1])
        nf.bind()
        nf.key = hi[0]
        return out + [leaf_prebound(nf)]
    return out + group


def leaf_prebound(f: Filter) -> Node:
    return Node(filter=f)


def _merge_or_eqs(group: list[Node]) -> list[Node]:
    eqs = [g for g in group if g.filter.mode == FilterMode.EQ]
    rest = [g for g in group if g.filter.mode != FilterMode.EQ]
    ins = [g for g in group if g.filter.mode == FilterMode.IN]
    rest = [g for g in rest if g.filter.mode != FilterMode.IN]
    if len(eqs) + len(ins) < 2:
        return group
    vals = [g.filter.value for g in eqs]
    for g in ins:
        vals.extend(g.filter.value)
    nf = Filter(eqs[0].filter.field if eqs else ins[0].filter.field,
                FilterMode.IN, vals)
    return rest + [leaf(nf)]


def _short_circuit(n: Node) -> Node:
    if n.is_leaf:
        return n
    kids = [_short_circuit(c) for c in n.children]
    out = []
    for c in kids:
        if c.is_leaf and c.filter.mode == FilterMode.TRUE:
            if n.or_:
                return c
            continue
        if c.is_leaf and c.filter.mode == FilterMode.FALSE:
            if not n.or_:
                return c
            continue
        out.append(c)
    if not out:
        # AND of TRUEs / OR of FALSEs
        any_field = n.children[0]
        while not any_field.is_leaf:
            any_field = any_field.children[0]
        mode = FilterMode.FALSE if n.or_ else FilterMode.TRUE
        return leaf(Filter(any_field.filter.field, mode))
    if len(out) == 1:
        return out[0]
    return Node(or_=n.or_, children=out)
