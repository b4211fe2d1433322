"""In-memory write journal: the mutable overlay over immutable segments (carried over from
knoxdb_tpu/pack/journal.py).

Semantics follow the reference journal (internal/pack/
journal/journal.go:22-50, insert.go:30-60, tomb.go): inserts/updates/
deletes land here first (WAL-backed), reads merge journal rows over
segment scan results with snapshot isolation, and a background merge
drains committed rows into new immutable segments.

Device-first inversion: the journal is host-only numpy (it is small and
mutation-heavy — the wrong shape for the device); segments are the
device-resident fast path. Journal query evaluation uses the same keyform
semantics as the kernels via a numpy reference evaluator (exec/oracle.py),
so merged results are bit-identical whether a row was found on device or
in the overlay.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..schema.schema import META_RID, META_XMIN, META_XMAX, Schema
from ..types import FilterMode, Snapshot

__all__ = ["Journal"]


@dataclass
class _Seg:
    """One journal segment: columnar CHUNKS in insert order.

    Each insert batch appends one numpy chunk per column (zero flatten;
    per-row list storage cost ~2 s/1M rows at merge) and
    one (xid, count) run to xmin_runs (inserts are per-xid batches)."""
    chunks: dict = field(default_factory=dict)     # name -> [np arrays]
    rid_chunks: list = field(default_factory=list)
    xmin_runs: list = field(default_factory=list)  # [(xid, count)]
    n: int = 0

    def xids(self):
        return (x for x, _ in self.xmin_runs)


class Journal:
    def __init__(self, schema: Schema, max_size: int = 1 << 17):
        self.schema = schema
        self.max_size = max_size
        self.tip = _Seg()
        self.tail: list[_Seg] = []          # immutable full segments
        # tombstones: rid -> xid that deleted it (may target segment rows)
        self.tomb: dict[int, int] = {}
        # per-row xmax for journal rows replaced/deleted (parallel to data)
        self._committed: set[int] = set()   # committed xids
        self._aborted: set[int] = set()

    # ------------------------------------------------------------- write --

    def insert(self, xid: int, rids: np.ndarray, data: dict) -> None:
        """Append rows (already assigned rids) under transaction xid."""
        n = len(rids)
        seg = self.tip
        for f in self.schema.fields:
            seg.chunks.setdefault(f.name, []).append(
                _tochunk(data[f.name], n))
        seg.rid_chunks.append(np.asarray(rids, np.uint64)[:n].copy())
        seg.xmin_runs.append((xid, n))
        seg.n += n
        if seg.n >= self.max_size:
            self.rotate()

    def delete(self, xid: int, rids) -> int:
        tomb = self.tomb
        if not tomb:
            # bulk fast path: dict.update at C speed (a 1M-row delete
            # spends ~1 s in the per-rid python loop otherwise)
            rl = np.asarray(rids, np.uint64).tolist()
            tomb.update(zip(rl, [xid] * len(rl)))
            return len(rl)
        cnt = 0
        committed = self._committed
        for r in np.asarray(rids, np.uint64).tolist():
            prev = tomb.get(r)
            if prev is not None and prev in committed:
                continue
            tomb[r] = xid
            cnt += 1
        return cnt

    def rotate(self) -> None:
        if self.tip.n:
            self.tail.append(self.tip)
            self.tip = _Seg()

    def commit(self, xid: int) -> None:
        self._committed.add(xid)

    def abort(self, xid: int) -> None:
        self._aborted.add(xid)

    # -------------------------------------------------------------- read --

    @property
    def nrows(self) -> int:
        return self.tip.n + sum(s.n for s in self.tail)

    def is_empty(self) -> bool:
        return self.nrows == 0 and not self.tomb

    def _segments(self):
        yield from self.tail
        if self.tip.n:
            yield self.tip

    def visible_rows(self, snap: Snapshot) -> tuple[dict, np.ndarray]:
        """All journal rows visible under snapshot (insert order).

        Returns (data dict of arrays, rids u64). A row is visible when
        its inserting xid is visible and no visible tombstone covers its
        rid. VECTORIZED: visibility evaluates once per (xid run) and
        expands by np.repeat; tombstone exclusion is one np.isin per
        segment (a per-row python loop cost ~2 s/1M rows)."""
        names = [f.name for f in self.schema.fields]
        col_parts: dict[str, list] = {n: [] for n in names}
        rid_parts: list[np.ndarray] = []
        trids = np.array(
            [r for r, x in self.tomb.items() if self._xid_visible(x, snap)],
            np.uint64) if self.tomb else None
        for seg in self._segments():
            if not seg.n:
                continue
            run_vis = [self._xid_visible(x, snap) for x, _ in seg.xmin_runs]
            counts = [c for _, c in seg.xmin_runs]
            vis = np.repeat(run_vis, counts)
            rids_arr = np.concatenate(seg.rid_chunks)
            if trids is not None and len(trids):
                vis = vis & ~np.isin(rids_arr, trids)
            if not vis.any():
                continue
            if vis.all():
                rid_parts.append(rids_arr)
                for n in names:
                    col_parts[n].extend(seg.chunks[n])
            else:
                idx = np.flatnonzero(vis)
                rid_parts.append(rids_arr[idx])
                for n in names:
                    col_parts[n].append(_concat(seg.chunks[n])[idx])
        if not rid_parts:
            return ({n: np.empty(0, object) for n in names},
                    np.empty(0, np.uint64))
        out = {n: _concat(col_parts[n]) for n in names}
        return out, np.concatenate(rid_parts)

    def deleted_rids(self, snap: Snapshot) -> np.ndarray:
        """Rids with a visible tombstone (for the segment exclude mask)."""
        out = [r for r, x in self.tomb.items() if self._xid_visible(x, snap)]
        return np.array(sorted(out), np.uint64)

    def _xid_visible(self, xid: int, snap: Snapshot) -> bool:
        if xid in self._aborted:
            return False
        if xid == snap.xown:
            return True
        if snap.xmax and xid >= snap.xmax:
            return False
        if xid in snap.xact:
            return False
        return xid in self._committed or not snap.xmax

    # ------------------------------------------------------------- merge --

    def mergable(self) -> tuple[dict, np.ndarray, np.ndarray, set[int]] | None:
        """Committed rows ready to merge into segments.

        Returns (data, rids, deleted_rids, drained_xids) or None. Aborted
        rows are dropped; uncommitted rows stay (the caller only merges
        when everything pending is committed — reference NextMergable
        semantics simplified to full-drain)."""
        pending = set()
        for seg in self._segments():
            for x in seg.xids():
                if x not in self._committed and x not in self._aborted:
                    pending.add(x)
        for x in self.tomb.values():
            if x not in self._committed and x not in self._aborted:
                pending.add(x)
        if pending:
            return None
        snap = Snapshot(xown=0, xmin=0, xmax=0, xact=frozenset())
        data, rids = self.visible_rows(snap)
        deleted = self.deleted_rids(snap)
        drained = set(self._committed)
        return data, rids, deleted, drained

    def clear(self) -> None:
        self.tip = _Seg()
        self.tail = []
        self.tomb.clear()
        self._committed.clear()
        self._aborted.clear()

    def drop_drained(self, tail_segs: list, tomb: dict, xids: set) -> None:
        """Remove exactly the content a merge drained (captured under the
        table lock before the merge built its segment). Rows/tombstones
        inserted AFTER the capture — concurrent transactions — survive,
        unlike a blanket clear() which would silently lose them."""
        drained_ids = {id(s) for s in tail_segs}
        self.tail = [s for s in self.tail if id(s) not in drained_ids]
        for r, x in tomb.items():
            if self.tomb.get(r) == x:
                del self.tomb[r]
        # an xid can only be drained when fully committed/aborted at
        # capture time (mergable() guarantees no pending), so dropping the
        # outcome sets is safe for rows inserted later under NEW xids
        self._committed -= xids
        self._aborted -= xids


def _tochunk(col, n: int) -> np.ndarray:
    """One insert batch -> an owned numpy chunk. Numeric/bool arrays
    keep their dtype (exactness: int128+/decimal wide values arrive as
    object arrays and stay object); everything else (python lists,
    strings, mixed) becomes an object array — preserving the python
    values exactly like the old per-row list storage did."""
    if isinstance(col, np.ndarray) and col.dtype.kind in "iufb":
        return col[:n].astype(col.dtype, copy=True)
    if isinstance(col, np.ndarray) and col.dtype == object:
        return col[:n].copy()
    a = np.empty(min(n, len(col)), object)
    for i in range(len(a)):
        a[i] = col[i]
    return a


def _concat(parts: list) -> np.ndarray:
    """Concatenate column chunks. ANY dtype mix promotes to object:
    numpy would promote int64+uint64 to FLOAT64 and silently destroy
    large integers (e.g. 2^63+5 -> 9.22e18) — the exactness invariant
    forbids that. Same-dtype chunks (the overwhelmingly common case)
    concatenate natively."""
    if not parts:
        return np.empty(0, object)
    if len(parts) == 1:
        return parts[0]
    dt0 = parts[0].dtype
    if any(p.dtype != dt0 for p in parts):
        parts = [p.astype(object) for p in parts]
    return np.concatenate(parts)
