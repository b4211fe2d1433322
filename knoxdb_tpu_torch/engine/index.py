"""Secondary indexes: hash / int / composite -> rid sets (carried over from
knoxdb_tpu/engine/index.py).

Analog of the reference pack index engine (internal/pack/
index/index.go:24-26,51-66, query.go): indexes map key -> row ids and
decorate query plans with rid restrictions (the reference injects
`$rid IN bitmap` conditions, internal/query/plan.go:312-449).

Device-first shape: because segments are immutable and rebuilt on merge, an
index is a per-table sorted (key, rid) pair of host arrays rebuilt from
segment metadata at merge time — lookups are binary searches; the result
rid set becomes a positional INCLUDE bitset ANDed into the device scan
mask (same mechanism as the journal exclude mask).

Kinds (reference index.go:24-26):
- HASH: EQ/IN only (key = keyform or byte hash)
- INT:  EQ..RANGE (key = keyform int)
- COMPOSITE: multi-field prefix EQ (key = tuple-concatenated keyform)
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np

from ..exec import oracle as ORC
from ..types import FilterMode, IndexType
from ..utils.ridset import RidSet

__all__ = ["PackIndex"]


@dataclass
class PackIndex:
    name: str
    kind: IndexType
    fields: list[str]            # one field (hash/int) or several (composite)
    keys: np.ndarray = dc_field(default_factory=lambda: np.empty(0, object))
    rids: np.ndarray = dc_field(default_factory=lambda: np.empty(0, np.uint64))

    def rebuild(self, table) -> None:
        """Recompute from sealed segments (called after merge)."""
        key_parts: list[np.ndarray] = []
        rid_parts: list[np.ndarray] = []
        for h in table.segments:
            alive = np.ones(len(h.host_rid), bool)
            if h.dead_rids is not None and len(h.dead_rids):
                alive &= ~np.isin(h.host_rid, h.dead_rids)
            mat = table._materialize_all(
                h, alive, fields=sorted(set(self.fields) | {"$rid"}))
            rids = np.asarray(mat["$rid"], np.uint64)
            keys = self._make_keys(table, mat, len(rids))
            key_parts.append(keys)
            rid_parts.append(rids)
        if not key_parts:
            self.keys = np.empty(0, object)
            self.rids = np.empty(0, np.uint64)
            return
        keys = np.concatenate(key_parts)
        rids = np.concatenate(rid_parts)
        order = np.argsort(keys, kind="stable")
        self.keys = keys[order]
        self.rids = rids[order]

    def apply_merge(self, table, dead_rids, jdata: dict | None,
                    jrids) -> None:
        """INCREMENTAL maintenance at merge (reference AddPack/DelPack,
        internal/engine/interface.go:207-208): drop tombstoned rids,
        merge-insert the drained journal rows. O(index + drained) —
        never re-decodes sealed segments (fold/rewrite preserve every
        surviving (key, rid) pair, so only deletes and fresh journal
        rows change the index)."""
        keys, rids = self.keys, self.rids
        if dead_rids is not None and len(dead_rids) and len(rids):
            alive = ~np.isin(rids, np.asarray(dead_rids, np.uint64))
            keys, rids = keys[alive], rids[alive]
        if jrids is not None and len(jrids):
            nk = self._make_keys(table, jdata, len(jrids))
            nr = np.asarray(list(jrids), np.uint64)
            if len(keys):
                # true merge-insert, O(index + drained) rather than an
                # O(index log index) full argsort: sort only the DRAINED
                # rows, binary-search their slots, one linear insert
                # copy. side="right" keeps new rows after equal keys,
                # matching the old stable concat-argsort order.
                no = np.argsort(nk, kind="stable")
                nk, nr = nk[no], nr[no]
                pos = np.searchsorted(keys, nk, side="right")
                keys = np.insert(keys, pos, nk)
                rids = np.insert(rids, pos, nr)
            else:
                order = np.argsort(nk, kind="stable")
                keys, rids = nk[order], nr[order]
        self.keys, self.rids = keys, rids

    def _make_keys(self, table, mat: dict, n: int) -> np.ndarray:
        parts = []
        for fname in self.fields:
            ft = table.full_schema.field(fname).type
            if ft.is_bytes_like:
                parts.append(np.array(
                    [v.encode() if isinstance(v, str) else bytes(v)
                     for v in mat[fname]], object))
            else:
                parts.append(ORC.column_keys(mat[fname], ft))
        if len(parts) == 1:
            return parts[0]
        out = np.empty(n, object)
        for i in range(n):
            out[i] = tuple(p[i] for p in parts)
        return out

    # ------------------------------------------------------------ lookup --

    def lookup_eq(self, key) -> "RidSet":
        # bisect handles tuple keys (composite) that searchsorted cannot
        import bisect
        lo = bisect.bisect_left(self.keys, key)
        hi = bisect.bisect_right(self.keys, key)
        return RidSet.from_array(self.rids[lo:hi])

    def lookup_in(self, keys) -> "RidSet":
        out = RidSet.empty()
        for k in keys:
            out = out.union(self.lookup_eq(k))
        return out

    def lookup_range(self, lo_key, hi_key) -> "RidSet":
        if self.kind == IndexType.HASH:
            raise ValueError("hash index supports EQ/IN only")
        import bisect
        lo = bisect.bisect_left(self.keys, lo_key)
        hi = bisect.bisect_right(self.keys, hi_key)
        return RidSet.from_array(self.rids[lo:hi])

    def can_serve(self, leaf) -> bool:
        """Does this index serve a filter leaf (reference plan.go index
        selection)?"""
        if leaf.field.name != self.fields[0] or len(self.fields) > 1:
            return False
        if self.kind == IndexType.HASH:
            return leaf.mode in (FilterMode.EQ, FilterMode.IN)
        if self.kind == IndexType.INT:
            return leaf.mode in (FilterMode.EQ, FilterMode.IN,
                                 FilterMode.LT, FilterMode.LE,
                                 FilterMode.GT, FilterMode.GE,
                                 FilterMode.RANGE)
        return False

    def query_leaf(self, leaf) -> np.ndarray:
        """Rids matching one leaf (keys in keyform / bytes domain)."""
        ft = leaf.field.type
        if ft.is_bytes_like:
            if leaf.mode == FilterMode.EQ:
                return self.lookup_eq(leaf.value_bytes)
            if leaf.mode == FilterMode.IN:
                return self.lookup_in(leaf.value_bytes)
            raise ValueError("byte index leaf")
        m = leaf.mode
        if m == FilterMode.EQ:
            return self.lookup_eq(leaf.key)
        if m == FilterMode.IN:
            return self.lookup_in([int(k) for k in leaf.keys])
        if m == FilterMode.RANGE:
            return self.lookup_range(leaf.key, leaf.key_hi)
        if m == FilterMode.LT:
            return self.lookup_range(0, leaf.key - 1)
        if m == FilterMode.LE:
            return self.lookup_range(0, leaf.key)
        if m == FilterMode.GT:
            return self.lookup_range(leaf.key + 1, (1 << 64) - 1)
        if m == FilterMode.GE:
            return self.lookup_range(leaf.key, (1 << 64) - 1)
        raise ValueError(f"index leaf {m}")
