"""Pack table engine: insert/update/delete via journal, query via fused
segment scan + overlay merge, background merge into immutable segments.

The port of knoxdb_tpu/engine/table.py: host code over the port's
SegmentScanner, each sealed segment uploaded to the engine's torch device
(`Engine.device`, the card unless the caller asks for the CPU). It keeps
the upstream pack table engine's contract (internal/pack/table/
table.go:58-73, insert.go:55-91, query.go:27-144, merge.go:21-101):

- immutable device-resident segments are the fast path (exec/scan.py);
  the journal overlay is host numpy (pack/journal.py)
- deletes/updates tombstone rids; pre-merge visibility is enforced by an
  EXCLUDE bitset ANDed into the device mask (the reference's journal
  exclude-mask, reader.go:349-376); merges apply tombstones physically
- merge = drain committed journal (+ undersized tail segments) -> sort by
  pk -> rebuild segment -> swap + WAL checkpoint (crash-safe: the WAL
  replays the journal until the checkpoint record lands, reference
  merge.go:92-101 protocol)
- rows carry $rid (global, monotonic) and $xmin system columns
  (pkg/schema/meta.go); full-drain merges mean sealed rows are visible to
  every later snapshot.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from ..exec import device as D
from ..exec import oracle as ORC
from ..exec.device import DeviceSegment
from ..exec.scan import AggSpec, ScanResult, SegmentScanner
from ..ops import bitset as bs
from ..pack.journal import Journal
from ..pack.segment import Segment, build_segment
from ..query.filter import Filter, Node, leaf
from ..schema.schema import META_RID, META_XMIN, Schema
from ..schema.wire import decode_batch, encode_batch
from ..types import FieldType, FilterMode, Snapshot
from ..utils import limbs as lb
from ..wal.wal import Record, RecordType

__all__ = ["Table", "TableState", "TableMetrics"]


def _as_dtype(p, dt) -> np.ndarray:
    """Column part -> array of dtype dt WITHOUT a python-list round trip
    for the common case (journal chunks are native numeric arrays; a
    1M-row list() detour cost ~0.7 s per merge)."""
    if isinstance(p, np.ndarray):
        if p.dtype == dt:
            return p
        if p.dtype.kind in "iufbO":
            return p.astype(dt)
    return np.asarray(list(p), dt)


@dataclass
class TableState:
    """Durable counters (reference internal/engine/state.go)."""
    next_pk: int = 1
    next_rid: int = 1
    n_rows: int = 0
    epoch: int = 0
    checkpoint_lsn: int = 0

    def to_dict(self):
        return self.__dict__.copy()

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


@dataclass
class TableMetrics:
    """Atomic-ish counters (reference internal/engine/metrics.go:38-73)."""
    inserted_tuples: int = 0
    updated_tuples: int = 0
    deleted_tuples: int = 0
    queried_tuples: int = 0
    num_calls: int = 0
    journal_tuples: int = 0
    packs_scanned: int = 0
    packs_pruned: int = 0
    merges: int = 0
    bytes_stored: int = 0


@dataclass
class _SegHandle:
    seg: Segment
    host_pk: np.ndarray          # u64 pk per row (engine bookkeeping)
    host_rid: np.ndarray         # u64 rid per row
    dseg: DeviceSegment | None = None
    scanner: SegmentScanner | None = None
    exclude_cache: tuple | None = None   # (tomb_version, device words)
    blob_key: str | None = None          # persisted blob key (None = dirty)
    blob_bytes: int = 0
    # INCREMENTAL MERGE: physically-deleted rids of this sealed
    # segment. Instead of rewriting a whole segment for a few dead rows
    # (O(table) merges under scattered deletes), merge marks them here; scans AND ~dead into the mask
    # (same mechanism as the journal exclude mask). A segment is only
    # rewritten once its dead fraction crosses Table.DEAD_REWRITE_FRAC
    # (reference analog: pack-granular Writer.Replace, merge.go:21-101).
    dead_rids: np.ndarray | None = None  # u64, sorted unique
    dead_key: str | None = None          # persisted dead-blob key
    _dead_words: np.ndarray | None = None  # lazy packed u32[P, W]

    table: object = None

    def dead_words_np(self) -> np.ndarray | None:
        """Packed positional bitset of dead rows (None when no deads)."""
        if self.dead_rids is None or not len(self.dead_rids):
            return None
        if self._dead_words is None:
            P, N = self.seg.npacks, self.seg.pack_size
            m = np.zeros(P * N, bool)
            hits = np.flatnonzero(np.isin(self.host_rid, self.dead_rids))
            m[hits] = True
            self._dead_words = bs.np_pack_mask(m).reshape(P, N // 32)
        return self._dead_words

    @property
    def n_dead(self) -> int:
        return 0 if self.dead_rids is None else len(self.dead_rids)

    @property
    def n_live(self) -> int:
        return self.seg.nrows_total - self.n_dead

    def scanner_(self) -> SegmentScanner:
        # read/build through locals: a concurrent cache eviction may null
        # self.dseg/self.scanner at any point; the returned scanner stays
        # valid because the caller holds the only reference it needs. A
        # fresh scanner starts with empty plan and operand caches.
        sc = self.scanner
        if sc is None:
            dev = self.table.engine.device
            mesh = self.table.engine.mesh
            sc = None
            if mesh is not None:
                # a uniform segment's columns live in the mesh's shards:
                # the scanner plans over host metadata alone
                from ..parallel.engine_spmd import (ShardedScanner,
                                                    is_uniform_segment)
                ds = DeviceSegment(self.seg, dev, arrays=False)
                if is_uniform_segment(ds, mesh.shape[mesh.axis_names[0]]):
                    sc = ShardedScanner(ds, mesh, axis=mesh.axis_names[0])
            if sc is None:
                ds = DeviceSegment(self.seg, dev)
                sc = SegmentScanner(ds)
            self.dseg = ds
            self.scanner = sc
        self.table.engine.cache.note_use(self)
        return sc


class Table:
    MIN_MERGE_TAIL = 4   # segments smaller than pack_size*this merge together
    # incremental-merge policy: a sealed segment with dead rows is
    # only REWRITTEN once its dead fraction crosses this; below it the
    # dead rids just extend the segment's persistent exclude bitmap
    # (O(tombstones) merge instead of O(table))
    DEAD_REWRITE_FRAC = 0.125
    # bounded segment count: beyond this the smallest sealed segments
    # fold together even above the tail threshold (long-lived tables
    # stop proliferating scanners and their plan caches)
    MAX_SEGMENTS = 12

    def __init__(self, engine, table_id: int, schema: Schema, *,
                 pack_size: int = 1 << 16, journal_size: int = 1 << 17,
                 history: bool = False):
        if pack_size < 32 or pack_size & (pack_size - 1):
            # device kernels assume 32 | N and power-of-two halving
            # reductions (exec/device._lex_minmax); reject early
            raise ValueError(f"pack_size must be a power of two >= 32, "
                             f"got {pack_size}")
        self.engine = engine
        self.id = table_id
        self.schema = schema
        self.full_schema = schema.with_meta()
        self.pack_size = pack_size
        self.state = TableState()
        self.metrics = TableMetrics()
        self.journal = Journal(self.full_schema, journal_size)
        self.segments: list[_SegHandle] = []
        self._tomb_version = 0
        self.indexes: list = []
        # history mode (reference registers table kinds 'pack' AND
        # 'history', internal/pack/table/table.go:27-30): updated/deleted
        # row versions append to a shadow table with $xmax = deleting xid
        self.history_enabled = history
        self.history_table: "Table | None" = None
        # _mu guards journal mutation + the segments-list/journal swap so
        # readers capture a consistent (segments, journal) view; _merge_mu
        # serializes whole merges (TaskService runs 2 workers).
        self._mu = threading.RLock()
        self._merge_mu = threading.Lock()
        self._seg_keys: list[str] = []       # persisted blob manifest
        self._seg_dead: dict[str, str] = {}  # blob key -> dead-rid blob
        self._next_blob = 0

    def _read_view(self, snap: Snapshot):
        """Atomically capture (segments, journal rows, tombstoned rids).

        The merge swap (segments := new, journal.drop_drained) holds the
        same lock, so a reader can never pair drained journal rows with
        the new segment that contains them (double count) or miss rows
        mid-swap (reference reader epoch pinning, reader.go:288-450)."""
        with self._mu:
            segments = list(self.segments)
            jdata, jrids = self.journal.visible_rows(snap)
            dead = self.journal.deleted_rids(snap)
        return segments, jdata, jrids, dead

    # ------------------------------------------------------------- write --

    def insert_rows(self, tx, data: dict, pks: np.ndarray | None = None
                    ) -> np.ndarray:
        """Insert a column batch; returns assigned pks. `data` holds the
        user schema columns; $rid/$xmin are assigned here."""
        n = len(next(iter(data.values())))
        pk_field = self.schema.pk
        if pk_field is None:
            raise ValueError("table has no pk")
        if pks is None:
            user_pk = np.asarray(data.get(pk_field.name, np.zeros(n, np.uint64)),
                                 np.uint64)
            if user_pk.any():
                pks = user_pk
                self.state.next_pk = max(self.state.next_pk,
                                         int(user_pk.max()) + 1)
            else:
                pks = np.arange(self.state.next_pk,
                                self.state.next_pk + n, dtype=np.uint64)
                self.state.next_pk += n
        rids = np.arange(self.state.next_rid, self.state.next_rid + n,
                         dtype=np.uint64)
        self.state.next_rid += n

        full = dict(data)
        full[pk_field.name] = pks
        full[META_RID] = rids
        full[META_XMIN] = np.full(n, tx.xid, np.uint64)
        full["$xmax"] = np.zeros(n, np.uint64)

        wal_body = encode_batch(self.full_schema, full, n)
        self.engine.wal.write(Record(RecordType.INSERT, self.id, tx.xid,
                                     wal_body))
        with self._mu:
            self.journal.insert(tx.xid, rids, full)
        tx.touch(self)
        self.metrics.inserted_tuples += n
        self.metrics.journal_tuples = self.journal.nrows
        self.state.n_rows += n
        return pks

    def delete_rows(self, tx, tree: Node) -> int:
        """Tombstone all rows matching the filter tree. Returns count."""
        rids = self._matching_rids(tx.snapshot, tree)
        if not len(rids):
            return 0
        self._archive_versions(tx, rids)
        body = np.asarray(rids, np.uint64).tobytes()
        self.engine.wal.write(Record(RecordType.DELETE, self.id, tx.xid, body))
        with self._mu:
            cnt = self.journal.delete(tx.xid, rids)
            self._tomb_version += 1
        tx.touch(self)
        self.metrics.deleted_tuples += cnt
        self.state.n_rows -= cnt
        return cnt

    def update_rows(self, tx, data: dict) -> int:
        """Update = tombstone old version by pk + insert new version with
        the same pk (reference journal update semantics)."""
        pk_name = self.schema.pk.name
        pks = np.asarray(data[pk_name], np.uint64)
        tree = leaf(Filter(self.schema.field(pk_name), FilterMode.IN,
                           pks)).optimize()
        rids = self._matching_rids(tx.snapshot, tree)
        if len(rids):
            self._archive_versions(tx, rids)
            body = np.asarray(rids, np.uint64).tobytes()
            self.engine.wal.write(Record(RecordType.DELETE, self.id, tx.xid,
                                         body))
            with self._mu:
                self.journal.delete(tx.xid, rids)
                self._tomb_version += 1
        self.insert_rows(tx, data, pks=pks)
        n = len(pks)
        self.metrics.updated_tuples += n
        self.metrics.inserted_tuples -= n
        self.state.n_rows -= len(rids)
        return n

    def _archive_versions(self, tx, rids: np.ndarray) -> None:
        """History mode: copy the dying row versions into the shadow
        table with $xmax = the deleting xid (queryable time travel)."""
        if not self.history_enabled or not len(rids):
            return
        rows = self._rows_by_rids(tx.snapshot, rids)
        if rows is None:
            return
        h = self.engine.history_table_for(self)
        n = len(next(iter(rows.values())))
        data = {f.name: rows[f.name] for f in self.schema.fields}
        data["$src_rid"] = np.asarray(list(rows[META_RID]), np.uint64)
        data["$src_xmin"] = np.asarray(list(rows[META_XMIN]), np.uint64)
        data["$del_xid"] = np.full(n, tx.xid, np.uint64)
        # pk uniqueness doesn't hold in history: use engine-assigned pks
        data[h.schema.pk.name] = np.zeros(n, np.uint64)
        h.insert_rows(tx, data)

    def _rows_by_rids(self, snap: Snapshot, rids: np.ndarray) -> dict | None:
        """Materialize full rows for a rid set (segments + journal)."""
        names = [f.name for f in self.full_schema.fields]
        cols: dict[str, list] = {n: [] for n in names}
        got = 0
        segments, jdata, jrids, dead = self._read_view(snap)
        incl = self._rid_include_masks(rids, segments)
        excl = self._exclude_masks_of(segments, dead)
        for h, inc, exc in zip(segments, incl, excl):
            r = h.scanner_().scan(None, [AggSpec("count")], project=names,
                                  exclude_words=exc, include_words=inc)
            if r.rows.get(META_RID) is not None and len(r.rows[META_RID]):
                for n_ in names:
                    cols[n_].extend(list(r.rows[n_]))
                got += len(r.rows[META_RID])
        if len(jrids):
            jm = np.isin(jrids, np.asarray(rids, np.uint64))
            for i in np.flatnonzero(jm):
                for n_ in names:
                    cols[n_].append(jdata[n_][i])
                got += 1
        if not got:
            return None
        return {n_: np.array(v, object) for n_, v in cols.items()}

    def commit_tx(self, xid: int) -> None:
        with self._mu:
            self.journal.commit(xid)
            full = self.journal.nrows >= self.journal.max_size
        if full:
            self.engine.tasks.submit(self.merge)

    def abort_tx(self, xid: int) -> None:
        with self._mu:
            self.journal.abort(xid)
            self._tomb_version += 1

    # ------------------------------------------------------------ indexes --

    def create_index(self, fields, kind=None, name: str = "") -> "object":
        """Create a secondary index (reference TableEngine index factory,
        internal/engine/interface.go:207-208)."""
        from ..types import IndexType
        from .index import PackIndex
        if isinstance(fields, str):
            fields = [fields]
        if kind is None:
            kind = IndexType.INT if len(fields) == 1 else IndexType.COMPOSITE
        idx = PackIndex(name or "_".join(fields), kind, list(fields))
        idx.rebuild(self)
        self.indexes.append(idx)
        return idx

    def drop_index(self, name: str) -> None:
        self.indexes = [i for i in self.indexes if i.name != name]

    def _index_pushdown(self, tree: Node | None, segments: list):
        """If a top-level AND leaf is index-served, return per-segment
        INCLUDE bitsets restricting the scan (else None)."""
        if tree is None or not self.indexes or not segments:
            return None
        leaves = []
        if tree.is_leaf:
            leaves = [tree.filter]
        elif not tree.or_ and all(c.is_leaf for c in tree.children):
            leaves = [c.filter for c in tree.children]
        for f in leaves:
            for idx in self.indexes:
                if idx.can_serve(f):
                    rids = idx.query_leaf(f)
                    return self._rid_include_masks(rids, segments)
        return None

    def _rid_include_masks(self, rids, segments: list) -> list:
        """rids: RidSet (compressed roaring containers, xroar analog —
        utils/ridset.py) or a plain u64 array. The positional bitset is
        built per segment at scan time; the set itself stays KBs even
        when the table has billions of rows."""
        from ..utils.ridset import RidSet
        outs = []
        if not isinstance(rids, RidSet):
            rids = RidSet.from_array(np.asarray(rids, np.uint64))
        for h in segments:
            hits = np.flatnonzero(rids.isin(h.host_rid))
            P, N = h.seg.npacks, h.seg.pack_size
            m = np.zeros(P * N, bool)
            m[hits] = True
            outs.append(bs.np_pack_mask(m).reshape(P, N // 32))
        return outs

    # -------------------------------------------------------------- read --

    def query(self, snap: Snapshot, tree: Node | None,
              aggs: list[AggSpec] | None = None,
              project: list[str] | None = None, limit: int = 0) -> ScanResult:
        import time as _time
        aggs = aggs if aggs is not None else [AggSpec("count")]
        self.metrics.num_calls += 1
        # avg combines as (global sum / global count): scan sums instead
        scan_aggs = list(dict.fromkeys(
            AggSpec("sum", a.field) if a.op == "avg" else a for a in aggs))
        res = ScanResult()
        res.count = 0
        partial_aggs: list[ScanResult] = []
        t0 = _time.perf_counter()

        segments, jdata, jrids, dead = self._read_view(snap)
        excl_by_seg = self._exclude_masks_of(segments, dead)
        incl_by_seg = self._index_pushdown(tree, segments) \
            or [None] * len(segments)
        t_index = _time.perf_counter()
        for h, excl, incl in zip(segments, excl_by_seg, incl_by_seg):
            sc = h.scanner_()
            r = sc.scan(tree, scan_aggs, project=project,
                        limit=limit, exclude_words=excl, include_words=incl)
            partial_aggs.append(r)
            res.count += r.count
        t_scan = _time.perf_counter()

        # journal overlay (host oracle, same keyform semantics)
        jmask = None
        if len(jrids):
            jmask = ORC.eval_tree(tree, jdata, len(jrids))
            res.count += int(jmask.sum())
        t_journal = _time.perf_counter()

        self._combine(res, aggs, partial_aggs, jdata, jmask)
        if project:
            self._merge_rows(res, project, partial_aggs, jdata, jmask, limit)
        self.metrics.queried_tuples += res.count
        # per-query phase stats (reference internal/query/stats.go)
        res.stats["index_time"] = t_index - t0
        res.stats["scan_time"] = t_scan - t_index
        res.stats["journal_time"] = t_journal - t_scan
        res.stats["total_time"] = _time.perf_counter() - t0
        res.stats["packs_scanned"] = sum(
            p.stats.get("packs_scanned", 0) for p in partial_aggs)
        res.stats["packs_matched"] = sum(
            p.stats.get("packs_matched", 0) for p in partial_aggs)
        return res

    def stream_query(self, snap: Snapshot, tree: Node | None,
                     project: list[str], batch_packs: int = 64,
                     limit: int = 0):
        """STREAMING read path: yields column-batch dicts incrementally
        (reference operator pipeline pull model, operator/pipeline.go:
        26-38). Host memory stays bounded by one pack window; the
        snapshot taken at generator start pins one consistent view."""
        sent = 0
        segments, jdata, jrids, dead = self._read_view(snap)
        excl_by_seg = self._exclude_masks_of(segments, dead)
        incl_by_seg = self._index_pushdown(tree, segments) \
            or [None] * len(segments)
        for h, excl, incl in zip(segments, excl_by_seg, incl_by_seg):
            sc = h.scanner_()
            for res in sc.scan_stream(tree, project, batch_packs,
                                      exclude_words=excl,
                                      include_words=incl):
                batch = res.rows
                if limit and sent + res.count > limit:
                    keep = limit - sent
                    batch = {k: v[:keep] for k, v in batch.items()}
                    sent = limit
                else:
                    sent += res.count
                self.metrics.queried_tuples += res.count
                yield batch
                if limit and sent >= limit:
                    return
        if len(jrids):
            jmask = ORC.eval_tree(tree, jdata, len(jrids))
            if jmask.any():
                batch = {}
                for name in project:
                    ft = self.full_schema.field(name).type
                    jc = jdata[name][jmask]
                    if ft.nlimbs <= 2 and not ft.is_bytes_like:
                        jc = np.asarray(list(jc), lb.numpy_dtype(ft))
                    batch[name] = jc
                n = int(jmask.sum())
                if limit and sent + n > limit:
                    keep = limit - sent
                    batch = {k: v[:keep] for k, v in batch.items()}
                yield batch

    def group_query(self, snap: Snapshot, tree: Node | None,
                    group_field: str, aggs: list[tuple[str, str]]):
        """Group-by aggregation across segments + journal.

        aggs: list of (op, field) with op in count/sum/min/max/avg/var/std.
        Returns dict: {"keys": np values[G'], "count": i64[G'],
        (op, field): values[G']} for non-empty groups, key-ascending.

        FLOAT aggregates (reference reducer.go:24-48 aggregates float64):
        sum/avg/var/std ride the series moments kernel (fixed-order f64,
        ALP packs decode exactly — the float contract documented in
        series.py); min/max ride the fminmax keyform kernel (exact
        order-preserving u64 compares)."""
        ft_g = self.full_schema.field(group_field).type
        agg_fields_all = sorted({f for _, f in aggs if f})
        is_flt = {f: self.full_schema.field(f).type.is_float
                  for f in agg_fields_all}
        agg_fields = [f for f in agg_fields_all if not is_flt[f]]
        flt_sum = sorted({f for op, f in aggs
                          if f and is_flt[f] and op in ("sum", "avg")})
        flt_mm = sorted({f for op, f in aggs
                         if f and is_flt[f] and op in ("min", "max")})

        # union group-key domain across segments (host metadata only)
        from ..exec import groupby as GB
        segments, jdata, jrids, dead = self._read_view(snap)
        keysets = []
        for h in segments:
            keysets.append(GB.segment_group_keys(h.scanner_().d,
                                                 group_field))
        jmask = None
        jkeys = None
        if len(jrids):
            jmask = ORC.eval_tree(tree, jdata, len(jrids))
            if ft_g.is_bytes_like:
                jkeys = np.array(
                    [v.encode() if isinstance(v, str) else bytes(v)
                     for v in jdata[group_field]], object)
                if jmask.any():
                    keysets.append(np.unique(jkeys[jmask]))
            else:
                jkeys = ORC.column_keys(jdata[group_field], ft_g)
                if jmask.any():
                    keysets.append(np.unique(
                        np.array([int(k) for k in jkeys[jmask]], np.uint64)))
        if not keysets:
            return {"keys": np.empty(0), "count": np.empty(0, np.int64)}
        global_keys = np.unique(np.concatenate(keysets))
        G = len(global_keys)

        # vectorized accumulators: sums are OBJECT
        # ndarrays (exact python-int adds driven by numpy); min/max are
        # u64 keyform arrays with absorbing sentinels (a group's true
        # min/max can legally EQUAL a sentinel — combining stays exact
        # because min(x, MAX)=x and validity is keyed on counts>0, not
        # the sentinel value). No per-group python loops at any G.
        U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
        counts = np.zeros(G, np.int64)
        sums = {f: np.zeros(G, object) for f in agg_fields}
        mins = {f: np.full(G, U64MAX, np.uint64) for f in agg_fields_all}
        maxs = {f: np.zeros(G, np.uint64) for f in agg_fields_all}
        # var/std + float sum/avg: f64 moment partials (reference
        # reducer.go semantics; float contract documented in series.py)
        mom_fields = sorted({f for op, f in aggs
                             if op in ("var", "std")} | set(flt_sum))
        moments = {f: [np.zeros(G, np.int64), np.zeros(G, np.float64),
                       np.zeros(G, np.float64)] for f in mom_fields}

        # count/sum-only group queries skip the min/max scatters: the
        # group kernel (ops/group_kernels.py) takes counts and sums
        need_minmax = any(op in ("min", "max") and f and not is_flt[f]
                          for op, f in aggs)
        kinds: dict[str, set] = {}
        for f in mom_fields:
            kinds.setdefault(f, set()).add("moments")
        for f in flt_mm:
            kinds.setdefault(f, set()).add("fminmax")
        excl_by_seg = self._exclude_masks_of(segments, dead)
        for h, excl in zip(segments, excl_by_seg):
            gplan, c, res = h.scanner_().group_scan(
                tree, group_field, agg_fields, exclude_words=excl,
                global_keys=global_keys, minmax=need_minmax)
            counts += c
            if kinds:
                sp = h.scanner_().series_scan(
                    tree, group_field, kinds, gplan, exclude_words=excl)
                for f in mom_fields:
                    n_, s_, q_ = sp[(f, "moments")]
                    moments[f][0] += n_
                    moments[f][1] += s_
                    moments[f][2] += q_
                for f in flt_mm:
                    cf, mn_f, mx_f = sp[(f, "fminmax")]
                    has = cf > 0
                    mins[f] = np.minimum(mins[f], np.where(
                        has, np.asarray(mn_f, np.uint64), U64MAX))
                    maxs[f] = np.maximum(maxs[f], np.where(
                        has, np.asarray(mx_f, np.uint64), np.uint64(0)))
            for f in agg_fields:
                s, mn, mx = res[f]
                has = c > 0
                sums[f] = sums[f] + np.where(has, s, 0)
                mins[f] = np.minimum(mins[f], np.where(
                    has, np.asarray(mn, np.uint64), U64MAX))
                maxs[f] = np.maximum(maxs[f], np.where(
                    has, np.asarray(mx, np.uint64), np.uint64(0)))

        if jmask is not None and jmask.any():
            from ..series import _group_reduce_exact
            sel = np.flatnonzero(jmask)
            if ft_g.is_bytes_like or global_keys.dtype == object:
                # per-UNIQUE-key python compares only (searchsorted on
                # the sorted unique journal keys), never per-row dicts
                uq, inv = np.unique(jkeys[sel], return_inverse=True)
                gsel = np.searchsorted(global_keys, uq)[inv] \
                    .astype(np.int64)
            else:
                gsel = np.searchsorted(
                    global_keys, jkeys[sel].astype(np.uint64))
            np.add.at(counts, gsel, 1)
            for f in agg_fields_all:
                ftf = self.full_schema.field(f).type
                keys = ORC.column_keys(jdata[f][sel], ftf)
                gsum, gmin, gmax, hit = _group_reduce_exact(gsel, keys, G)
                if not is_flt[f]:
                    # float sums ride the moments loop below; float
                    # keyform min/max combine exactly here
                    sums[f] = sums[f] + np.where(hit, gsum, 0)
                gm = np.where(hit, gmin, int(U64MAX)).astype(np.uint64)
                gx = np.where(hit, gmax, 0).astype(np.uint64)
                mins[f] = np.minimum(mins[f], gm)
                maxs[f] = np.maximum(maxs[f], gx)
            for f in mom_fields:
                from ..series import _np_series_part
                ftf = self.full_schema.field(f).type
                keys = ORC.column_keys(jdata[f][sel], ftf)
                n_, s_, q_ = _np_series_part("moments", gsel, None, keys,
                                             G, ftf)
                moments[f][0] += n_
                moments[f][1] += s_
                moments[f][2] += q_

        keep = counts > 0
        from ..exec.groupby import GroupPlan
        gp = GroupPlan(global_keys[keep], int(keep.sum()), [])
        out = {"keys": gp.key_values(ft_g), "count": counts[keep]}
        kept = np.flatnonzero(keep)
        ck = counts[kept]
        for op, f in aggs:
            if op == "count" or not f:
                continue
            ftf = self.full_schema.field(f).type
            if ftf.is_float and op in ("sum", "avg"):
                n_, s_, _q = moments[f]
                vals = s_[kept] if op == "sum" else s_[kept] / ck
                out[(op, f)] = np.array(vals.tolist(), object)
                continue
            bias = (1 << (ftf.bits - 1)) if ftf.is_signed else 0
            if op in ("sum", "avg"):
                vals = sums[f][kept] - ck.astype(object) * bias
                if op == "avg":
                    vals = vals / ck        # object/int -> float, exact
                out[(op, f)] = vals
            elif op == "min":
                out[(op, f)] = _keys64_to_values(mins[f][kept], ftf)
            elif op == "max":
                out[(op, f)] = _keys64_to_values(maxs[f][kept], ftf)
            elif op in ("var", "std"):
                n_, s_, q_ = moments[f]
                n = n_[kept].astype(np.float64)
                with np.errstate(invalid="ignore", divide="ignore"):
                    var = np.maximum(
                        0.0, q_[kept] - s_[kept] * s_[kept]
                        / np.maximum(n, 1.0)) / np.maximum(n - 1.0, 1.0)
                    vals = np.where(n < 2, np.nan,    # reducer.go:375-378
                                    np.sqrt(var) if op == "std" else var)
                out[(op, f)] = np.array(vals.tolist(), object)
        return out

    # above this fraction of table rows a LIMIT stops being a top-k: the
    # per-segment radix-descent selection + host k-way entry merge cost
    # more than one materialize + vectorized argsort
    TOPK_MAX_FRACTION = 4

    def sorted_query(self, snap: Snapshot, tree: Node | None,
                     order_by: str, desc: bool = False, limit: int = 0,
                     project: list[str] | None = None) -> ScanResult:
        """ORDER BY (+ optional top-k LIMIT).

        Small limits: per-segment device top-k (bit-descent radix
        select), host k-way merge with journal rows by keyform key.
        Full orders / large limits: ONE device scan materializes the
        matching rows (vectorized compaction + decode), then a host
        keyform argsort reorders every projected column — no per-row
        python (reference streams ordered-by-pk natively,
        internal/pack/table/query.go:145-227; arbitrary-column ORDER BY
        exceeds it per the north star)."""
        from ..exec import sort as SRT
        project = project or [f.name for f in self.schema.fields]
        ft = self.full_schema.field(order_by).type
        from ..encode.schemes import Scheme as _Sch
        segments, jdata, jrids, dead = self._read_view(snap)
        has_alp = any(
            p.scheme == _Sch.ALP
            for h in segments
            for p in h.seg.columns.get(order_by,
                                       type("x", (), {"packs": []})).packs)
        total_rows = self.state.n_rows + self.journal.nrows
        use_topk = (limit and limit * self.TOPK_MAX_FRACTION <= total_rows
                    and not ft.is_bytes_like and not has_alp)
        if not use_topk:
            # byte order needs full-value ties; ALP packs mix enc
            # domains; no/large limit -> materialize + keyform sort
            res = self.query(snap, tree, [AggSpec("count")],
                             project=sorted(set(project) | {order_by}))
            if ft.is_bytes_like:
                key = np.array(
                    [v.encode() if isinstance(v, str) else bytes(v)
                     for v in res.rows[order_by]], object)
            elif ft.is_float:
                key = lb.to_keys64(
                    np.asarray(res.rows[order_by], np.float64), ft)
            elif ft.nlimbs <= 2:
                key = lb.to_keys64(
                    np.asarray(res.rows[order_by], lb.numpy_dtype(ft)), ft)
            else:
                key = ORC.column_keys(res.rows[order_by], ft)
            order = np.argsort(key, kind="stable")
            if desc:
                order = order[::-1]
            if limit:
                order = order[:limit]
            for name in list(res.rows):
                res.rows[name] = res.rows[name][order]
            res.count = len(order)
            return res
        k = limit
        # per-source candidates merged with ONE stable host argsort over
        # keyform keys, then every projected column assembles by
        # per-source fancy indexing + vectorized limbs->values
        # (lb.from_keyform) — no per-row python at any k
        key_parts: list[np.ndarray] = []   # object arrays of python ints
        src_parts: list[np.ndarray] = []
        row_parts: list[np.ndarray] = []

        excl_by_seg = self._exclude_masks_of(segments, dead)
        seg_rows = []
        for h, excl in zip(segments, excl_by_seg):
            kk = min(k, h.seg.nrows_total) or 1
            keys, rows, nvalid = SRT.segment_topk(
                h.scanner_(), tree, order_by, kk, desc=desc,
                project=project, exclude_words=excl)
            si = len(seg_rows)
            seg_rows.append(rows)
            if keys:
                key_parts.append(np.array(keys, object))
                src_parts.append(np.full(len(keys), si, np.int64))
                row_parts.append(np.arange(len(keys), dtype=np.int64))

        jmask = None
        if len(jrids):
            jmask = ORC.eval_tree(tree, jdata, len(jrids))
            jsel = np.flatnonzero(jmask)
            if len(jsel):
                jkeys = ORC.column_keys(jdata[order_by], ft)
                key_parts.append(
                    np.array([int(x) for x in jkeys[jsel]], object))
                src_parts.append(np.full(len(jsel), -1, np.int64))
                row_parts.append(jsel.astype(np.int64))

        res = ScanResult()
        if not key_parts:
            res.count = 0
            for name in project:
                ftf = self.full_schema.field(name).type
                dt = lb.numpy_dtype(ftf) \
                    if ftf.nlimbs <= 2 and not ftf.is_bytes_like else object
                res.rows[name] = np.empty(0, dt)
            return res
        allkeys = np.concatenate(key_parts)
        allsrc = np.concatenate(src_parts)
        allrow = np.concatenate(row_parts)
        # stable merge matching list.sort(reverse=desc): ties keep
        # source order in BOTH directions (argsort[::-1] would not)
        order = np.argsort(-allkeys if desc else allkeys, kind="stable")
        if limit:
            order = order[:limit]
        src_t = allsrc[order]
        row_t = allrow[order]
        n_out = len(order)

        res.count = n_out
        for name in project:
            ftf = self.full_schema.field(name).type
            narrow = ftf.nlimbs <= 2 and not ftf.is_bytes_like
            col = np.empty(n_out, lb.numpy_dtype(ftf) if narrow else object)
            for si in range(len(seg_rows)):
                at = np.flatnonzero(src_t == si)
                if not len(at):
                    continue
                lim = seg_rows[si][name][:, row_t[at]]
                col[at] = lb.from_keyform(lim, ftf)
            at = np.flatnonzero(src_t == -1)
            if len(at):
                jc = jdata[name][row_t[at]]
                if narrow:
                    jc = np.asarray(list(jc), lb.numpy_dtype(ftf))
                col[at] = jc
            res.rows[name] = col
        return res

    # -------------------------------------------------------------- join --
    # Global row-position encoding for join materialization: segment k's
    # rows occupy [sum of earlier segments' P*N, +P*N); journal row i is
    # JOIN_JBASE + i.
    JOIN_JBASE = 1 << 62

    def join_side(self, snap: Snapshot, tree: Node | None, field: str):
        """Device (join_keys, positions) of visible rows matching `tree`,
        plus the captured read view for later materialization. Both are
        1-d int64 tensors on the engine's device: the keys hold u64 key
        bits as exec/join carries them, mapped keyform -> two's-complement
        value domain so INT64 fks match UINT64 pks by numeric value.
        Only the tiny per-segment match COUNT crosses to the host here —
        keys and positions stay device-resident for join_pairs_device
        (never a wholesale column fetch)."""
        import torch
        from ..ops import compact as CP
        ft = self.full_schema.field(field).type
        if ft.is_bytes_like or ft.is_float or ft.nlimbs > 2:
            raise ValueError(f"join_side: {ft} keys use the host join path")
        # D.group_decode_keys gives the order-preserving int64 (the u64
        # with bit 63 flipped): flip it back, then flip signed keys'
        flip = 0 if ft.is_signed else -(1 << 63)
        view = self._read_view(snap)
        segments, jdata, jrids, dead = view
        excl = self._exclude_masks_of(segments, dead)
        dev = self.engine.device
        keys_parts, pos_parts = [], []
        base = 0
        for h, exc in zip(segments, excl):
            sc = h.scanner_()
            fn, args = sc.prepare(tree, [], exclude_words=exc)
            mask_words, counts, _ = fn(*args)
            total = int(counts.sum())
            d = sc.d
            if total:
                cap = min(1 << max(0, (total - 1).bit_length()), d.P * d.N)
                keys = sc._decode_rows(field, D.group_decode_keys)
                idx, _cnt = CP.packed_mask_to_indexes(mask_words, cap)
                safe = torch.where(idx == CP.SENTINEL, 0, idx).long()
                kk = torch.take(keys, safe)[:total]
                keys_parts.append(kk ^ flip)
                pos_parts.append((idx.long() & 0xFFFFFFFF)[:total] + base)
            base += d.P * d.N
        if len(jrids):
            jm = ORC.eval_tree(tree, jdata, len(jrids))
            sel = np.flatnonzero(jm)
            if len(sel):
                jkeys = np.asarray(
                    ORC.column_keys(jdata[field][sel], ft), np.uint64)
                nflip = np.uint64(1 << 63) if ft.is_signed else np.uint64(0)
                keys_parts.append(torch.from_numpy(
                    (jkeys ^ nflip).view(np.int64)).to(dev))
                pos_parts.append(torch.from_numpy(
                    self.JOIN_JBASE + sel.astype(np.int64)).to(dev))
        if not keys_parts:
            keys = torch.zeros(0, dtype=torch.int64, device=dev)
            pos = torch.zeros(0, dtype=torch.int64, device=dev)
        else:
            keys = torch.cat(keys_parts)
            pos = torch.cat(pos_parts)
        return keys, pos, view

    def rows_at_positions(self, view, positions: np.ndarray,
                          project: list[str]) -> dict:
        """Materialize rows for join_side-encoded positions (duplicates
        allowed; -1 -> None). Fetches ONLY the requested rows: matched
        positions become per-segment INCLUDE bitsets for the scan."""
        segments, jdata, jrids, dead = view
        if not project:          # side fully pruned by join select=
            return {}
        positions = np.asarray(positions, np.int64)
        out = {name: np.full(len(positions), None, object)
               for name in project}
        base = 0
        for h in segments:
            d = h.scanner_().d
            span = d.P * d.N
            m = (positions >= base) & (positions < base + span)
            if m.any():
                local = positions[m] - base
                uniq = np.unique(local)
                mm = np.zeros(span, bool)
                mm[uniq] = True
                incl = bs.np_pack_mask(mm).reshape(d.P, d.N // 32)
                r = h.scanner_().scan(None, [AggSpec("count")],
                                      project=project, include_words=incl)
                # row_ids are ascending (selection vectors): position ->
                # result index via searchsorted, not a 262k python dict
                rid_arr = np.asarray(r.row_ids, np.int64)
                take = np.searchsorted(rid_arr, local)
                for name in project:
                    out[name][m] = np.asarray(r.rows[name],
                                              object)[take]
            base += span
        jm = positions >= self.JOIN_JBASE
        if jm.any():
            jsel = (positions[jm] - self.JOIN_JBASE).astype(np.int64)
            for name in project:
                out[name][jm] = np.asarray(jdata[name], object)[jsel]
        return out

    def _matching_rids(self, snap: Snapshot, tree: Node | None) -> np.ndarray:
        """Rids of all visible rows matching the tree (for delete/update)."""
        out = []
        segments, jdata, jrids, dead = self._read_view(snap)
        excl_by_seg = self._exclude_masks_of(segments, dead)
        for h, excl in zip(segments, excl_by_seg):
            r = h.scanner_().scan(tree, [AggSpec("count")],
                                  project=[META_RID], exclude_words=excl)
            if len(r.rows.get(META_RID, ())):
                out.append(np.asarray(r.rows[META_RID], np.uint64))
        if len(jrids):
            jm = ORC.eval_tree(tree, jdata, len(jrids))
            if jm.any():
                out.append(jrids[jm])
        if not out:
            return np.empty(0, np.uint64)
        return np.concatenate(out)

    def _exclude_masks_of(self, segments: list, dead: np.ndarray) -> list:
        """Per-segment packed exclude bitsets: journal-tombstoned rids OR
        the segment's persistent dead bitmap (incremental merges mark
        rows dead in place instead of rewriting the segment).
        Pure function of a captured (segments, dead-rids) view."""
        outs = []
        for h in segments:
            dw = h.dead_words_np()
            if not len(dead):
                outs.append(dw)
                continue
            # host_rid is PK-ordered, NOT rid-ordered (updated rows carry
            # fresh rids at their pk position) — membership, not bisection
            hits = np.flatnonzero(np.isin(h.host_rid, dead))
            if not len(hits):
                outs.append(dw)
                continue
            P, N = h.seg.npacks, h.seg.pack_size
            m = np.zeros(P * N, bool)
            m[hits] = True
            w = bs.np_pack_mask(m).reshape(P, N // 32)
            outs.append(w if dw is None else (w | dw))
        return outs

    # --------------------------------------------------------- combining --

    def _combine(self, res, aggs, partials, jdata, jmask):
        for spec in aggs:
            key = (spec.op, spec.field)
            if spec.op == "count":
                res.aggs[key] = res.count
                continue
            ft = self.full_schema.field(spec.field).type
            op = "sum" if spec.op == "avg" else spec.op
            vals = [p.aggs.get((op, spec.field)) for p in partials]
            jval = None
            if jmask is not None and jmask.any():
                col = jdata[spec.field][jmask]
                jval = self._journal_agg(op, col, ft)
            combined = _combine_agg(op, vals, jval)
            if spec.op == "avg":
                combined = (combined / res.count) if res.count else None
            res.aggs[key] = combined

    def _journal_agg(self, op, col, ft: FieldType):
        if ft.is_float:
            a = np.asarray(list(col), np.float64)
            return {"sum": a.sum(), "min": a.min(), "max": a.max(),
                    "avg": a.mean()}[op]
        ints = [int(v) for v in col]
        return {"sum": sum(ints), "min": min(ints), "max": max(ints),
                "avg": sum(ints) / len(ints)}[op]

    def _merge_rows(self, res, project, partials, jdata, jmask, limit):
        cols = {name: [] for name in project}
        for p in partials:
            for name in project:
                if name in p.rows:
                    cols[name].append(np.asarray(p.rows[name]))
        if jmask is not None and jmask.any():
            for name in project:
                ft = self.full_schema.field(name).type
                jc = jdata[name][jmask]
                if ft.nlimbs <= 2 and not ft.is_bytes_like:
                    jc = np.asarray(list(jc), lb.numpy_dtype(ft))
                cols[name].append(jc)
        for name in project:
            if cols[name]:
                parts = cols[name]
                if any(p.dtype == object for p in parts):
                    res.rows[name] = np.concatenate(
                        [np.asarray(p, object) for p in parts])
                else:
                    res.rows[name] = np.concatenate(parts)
            else:
                res.rows[name] = np.empty(0)
            if limit:
                res.rows[name] = res.rows[name][:limit]
        if limit:
            res.count = min(res.count, limit)

    # ------------------------------------------------------------- merge --

    def merge(self) -> None:
        """Drain the committed journal (+ undersized tail segments) into a
        new sealed segment; crash-safe via WAL checkpoint.

        Protocol (reference merge.go:21-101 ordering, adapted):
          1. under the table lock: snapshot mergable journal content and
             rotate, so concurrent post-snapshot inserts land in a fresh
             tip and are never dropped by the drain
          2. build the new segment (slow, outside the lock; segments are
             immutable and only merges — serialized by _merge_mu — mutate
             the segment list)
          3. under the table lock: atomically swap segments + drop exactly
             the drained journal content
          4. persist new blobs under fresh keys, then durably save the
             (manifest, checkpoint LSN) pair in ONE atomic catalog put,
             and only then GC stale blobs — a crash at any point leaves
             either the full old state (+ WAL replay) or the full new one
        """
        with self._merge_mu:
            self._merge_serialized()

    def _merge_serialized(self) -> None:
        with self._mu:
            got = self.journal.mergable()
            if got is None:
                return
            jdata, jrids, dead, drained = got
            self.journal.rotate()
            drained_tail = list(self.journal.tail)
            drained_tomb = dict(self.journal.tomb)
            drained_xids = (set(self.journal._committed)
                            | set(self.journal._aborted))
            segments = list(self.segments)
        dead_set = set(int(r) for r in dead)
        dead_arr = np.asarray(dead, np.uint64)

        # fold in undersized tail segments (simple compaction policy)
        keep: list[_SegHandle] = []
        fold: list[_SegHandle] = []
        thresh = self.pack_size * self.MIN_MERGE_TAIL
        for h in segments:
            (fold if h.n_live < thresh else keep).append(h)
        # bounded segment count: fold the smallest sealed segments
        # beyond the cap (keeps scanner/jit state from proliferating on
        # long-lived tables; list ORDER of survivors is preserved —
        # first/last tie semantics follow segment order)
        over = len(keep) + 1 - self.MAX_SEGMENTS
        if over > 0:
            by_size = sorted(keep, key=lambda h: h.n_live)[:over + 1]
            victims = set(id(h) for h in by_size)
            fold.extend(h for h in keep if id(h) in victims)
            keep = [h for h in keep if id(h) not in victims]
        if not len(jrids) and not fold and not dead_set:
            with self._mu:
                self.journal.drop_drained(drained_tail, drained_tomb,
                                          drained_xids)
            return

        cols: dict[str, list] = {f.name: [] for f in self.full_schema.fields}
        pks: list[np.ndarray] = []

        def _alive_of(h: _SegHandle) -> np.ndarray:
            alive = np.ones(len(h.host_rid), bool)
            if dead_set:
                alive &= ~np.isin(h.host_rid, dead_arr)
            if h.dead_rids is not None and len(h.dead_rids):
                alive &= ~np.isin(h.host_rid, h.dead_rids)
            return alive

        def _fold_in(h: _SegHandle) -> None:
            mat = self._materialize_all(h, _alive_of(h))
            for name in cols:
                cols[name].append(mat[name])
            pks.append(mat[self.schema.pk.name].astype(np.uint64))

        for h in fold:
            _fold_in(h)
        # kept segments with NEW dead rows: extend the persistent dead
        # bitmap in place (O(tombstones)); rewrite only past the dead-
        # fraction threshold. Swapped in as FRESH handles so in-flight
        # readers keep their captured (handle, journal-tombstone) view.
        still_keep = []
        for h in keep:
            hits = np.isin(h.host_rid, dead_arr) if dead_set else None
            if hits is None or not hits.any():
                still_keep.append(h)
                continue
            combined = np.unique(np.concatenate(
                [h.dead_rids, h.host_rid[hits]])) \
                if h.dead_rids is not None and len(h.dead_rids) \
                else np.unique(h.host_rid[hits])
            if len(combined) >= h.seg.nrows_total * self.DEAD_REWRITE_FRAC:
                _fold_in(h)                     # reclaim: full rewrite
                continue
            still_keep.append(_SegHandle(
                h.seg, h.host_pk, h.host_rid, table=self,
                blob_key=h.blob_key, blob_bytes=h.blob_bytes,
                dead_rids=combined, dead_key=None))
        keep = still_keep
        if len(jrids):
            for name in cols:
                cols[name].append(jdata[name])
            pks.append(_as_dtype(jdata[self.schema.pk.name], np.uint64))

        new_handles = []
        if pks:
            allpk = np.concatenate(pks)
            order = np.argsort(allpk, kind="stable")
            data = {}
            for f in self.full_schema.fields:
                parts = cols[f.name]
                if f.type.nlimbs > 2 or f.type.is_bytes_like:
                    arr = np.concatenate([np.asarray(p, object)
                                          for p in parts])
                else:
                    arr = np.concatenate(
                        [_as_dtype(p, lb.numpy_dtype(f.type))
                         for p in parts])
                data[f.name] = arr[order]
            self.state.epoch += 1
            mesh = self.engine.mesh
            ndev = mesh.shape[mesh.axis_names[0]] if mesh is not None \
                else None
            seg = build_segment(self.full_schema, data, self.pack_size,
                                epoch=self.state.epoch, uniform=ndev)
            h = _SegHandle(seg,
                           host_pk=_as_dtype(data[self.schema.pk.name],
                                             np.uint64),
                           host_rid=_as_dtype(data[META_RID], np.uint64),
                           table=self)
            new_handles.append(h)

        # atomic swap: readers holding _read_view never see a half state
        with self._mu:
            self.segments = keep + new_handles
            self.journal.drop_drained(drained_tail, drained_tomb,
                                      drained_xids)
            self._tomb_version += 1
            self.metrics.journal_tuples = self.journal.nrows
        # durability: new blobs first (staged, unreferenced), then the
        # checkpoint record, then ONE atomic catalog put that flips both
        # the segment manifest and checkpoint_lsn; stale blobs last
        self._persist()
        lsn = self.engine.wal.write_and_sync(
            Record(RecordType.CHECKPOINT, self.id, 0,
                   str(self.state.epoch).encode()))
        self.state.checkpoint_lsn = lsn
        self.metrics.merges += 1
        for idx in self.indexes:
            idx.apply_merge(self, dead_arr, jdata if len(jrids) else None,
                            jrids)
        self.engine.save_state(self)
        self._gc_blobs()

    def truncate(self) -> None:
        """Remove ALL rows; keep schema, indexes, pk/rid counters
        (reference engine.TruncateTable, engine/table.go:257-287).
        Follows the merge durability protocol: in-memory swap under the
        table lock, empty manifest + checkpoint_lsn flipped in one
        atomic catalog put, stale blobs GC'd after — a crash at any
        point replays to either the old rows or none, never partial.
        Serialized against merges (_merge_mu): a merge mid-build would
        otherwise swap its pre-truncate segment back in (resurrection)."""
        with self._merge_mu:
            self._truncate_serialized()

    def _truncate_serialized(self) -> None:
        with self._mu:
            self.journal.clear()
            self.segments = []
            self._tomb_version += 1
            self.state.epoch += 1
            self.state.n_rows = 0
            self.metrics.journal_tuples = 0
        self._persist()
        lsn = self.engine.wal.write_and_sync(
            Record(RecordType.CHECKPOINT, self.id, 0,
                   str(self.state.epoch).encode()))
        self.state.checkpoint_lsn = lsn
        for idx in self.indexes:
            idx.rebuild(self)
        self.engine.save_state(self)
        self._gc_blobs()

    def _materialize_all(self, h: _SegHandle, alive: np.ndarray,
                         fields: list[str] | None = None) -> dict:
        """Row materialization of a segment (merge/index path, host).
        fields restricts the projection (index rebuild needs only the
        indexed columns + $rid)."""
        tree = None
        sc = h.scanner_()
        names = fields or [f.name for f in self.full_schema.fields]
        # exclude = ~alive as packed words
        P, N = h.seg.npacks, h.seg.pack_size
        m = np.zeros(P * N, bool)
        m[:len(alive)][~alive] = True
        excl = bs.np_pack_mask(m).reshape(P, N // 32)
        r = sc.scan(tree, [AggSpec("count")], project=names,
                    exclude_words=excl)
        return r.rows

    def _persist(self) -> None:
        """Write NEW segment blobs under fresh staged keys; never touches
        blobs referenced by the currently-durable manifest (deleted only
        by _gc_blobs after the new manifest is durable)."""
        if self.engine.store is None:
            self.metrics.bytes_stored = sum(
                h.seg.nbytes for h in self.segments)
            return
        from ..store import segio
        b = self.engine.store.bucket(f"table_{self.id}_segments")
        total = 0
        live: list[str] = []
        dead_map: dict[str, str] = {}
        for h in self.segments:
            if h.blob_key is None:
                key = f"{h.seg.epoch:08x}_{self._next_blob:06x}"
                self._next_blob += 1
                blob = segio.dump_segment(h.seg)
                b.put(key.encode(), blob)
                h.blob_key = key
                h.blob_bytes = len(blob)
            if h.dead_rids is not None and len(h.dead_rids):
                if h.dead_key is None:
                    # fresh VERSIONED blob per change: the old manifest
                    # keeps referencing the old one until the catalog
                    # flip (same staged-blob protocol as segments)
                    dk = f"{h.blob_key}_dead_{self._next_blob:06x}"
                    self._next_blob += 1
                    b.put(dk.encode(),
                          np.asarray(h.dead_rids, np.uint64).tobytes())
                    h.dead_key = dk
                dead_map[h.blob_key] = h.dead_key
            live.append(h.blob_key)
            total += h.blob_bytes
        self._seg_keys = live
        self._seg_dead = dead_map
        self.metrics.bytes_stored = total

    def _gc_blobs(self) -> None:
        """Delete blobs not referenced by the durable manifest (runs only
        AFTER engine.save_state made the new manifest durable)."""
        if self.engine.store is None:
            return
        b = self.engine.store.bucket(f"table_{self.id}_segments")
        live = set(self._seg_keys) | set(self._seg_dead.values())
        for k in list(b.keys()):
            if k.decode() not in live:
                b.delete(k)

    # ----------------------------------------------------------- recover --

    def load_segments(self) -> None:
        from ..store import segio
        if self.engine.store is None:
            return
        try:
            b = self.engine.store.bucket(f"table_{self.id}_segments",
                                         create=False)
        except KeyError:
            return
        if self._seg_keys:
            # manifest-driven load: staged blobs from an interrupted merge
            # are ignored (and GC'd on the next merge)
            keys = [k.encode() for k in self._seg_keys]
        else:
            keys = list(b.keys())
            self._seg_keys = [k.decode() for k in keys]
        for k in keys:
            blob = b.get(k)
            if blob is None:
                raise IOError(f"segment blob {k!r} missing for table "
                              f"{self.schema.name}")
            seg = segio.load_segment(blob)
            pk_name = self.schema.pk.name
            pkv = _decode_u64_column(seg, pk_name)
            ridv = _decode_u64_column(seg, META_RID)
            dead = None
            dkey = self._seg_dead.get(k.decode())
            if dkey is not None:
                db = b.get(dkey.encode())
                if db is None:
                    raise IOError(f"dead-rid blob {dkey!r} missing for "
                                  f"table {self.schema.name}")
                dead = np.frombuffer(db, np.uint64).copy()
            self.segments.append(_SegHandle(seg, pkv, ridv, table=self,
                                            blob_key=k.decode(),
                                            blob_bytes=len(blob),
                                            dead_rids=dead,
                                            dead_key=dkey))

    def replay_wal(self) -> None:
        """Rebuild journal from WAL records after the checkpoint
        (reference pack/table/wal.go:26). Recovery reads with TRUNCATE:
        a torn tail record — the normal artifact of a crash mid-append —
        is cut off instead of failing the open (reference wal.go:33-40)."""
        from ..wal.wal import RecoveryMode
        from_lsn = self.state.checkpoint_lsn
        staged: dict[int, list[Record]] = {}
        outcome: dict[int, RecordType] = {}
        for rec in self.engine.wal.records(from_lsn=from_lsn,
                                           mode=RecoveryMode.TRUNCATE):
            if rec.entity != self.id and rec.type not in (
                    RecordType.COMMIT, RecordType.ABORT):
                continue
            if rec.type in (RecordType.COMMIT, RecordType.ABORT):
                outcome[rec.txid] = rec.type
            elif rec.type in (RecordType.INSERT, RecordType.DELETE):
                staged.setdefault(rec.txid, []).append(rec)
        for xid, rs in staged.items():
            for rec in rs:
                if rec.type == RecordType.INSERT:
                    data, n = decode_batch(self.full_schema, rec.data)
                    rids = np.asarray(list(data[META_RID]), np.uint64)
                    self.journal.insert(xid, rids, data)
                    if len(rids):
                        self.state.next_rid = max(self.state.next_rid,
                                                  int(rids.max()) + 1)
                        pkv = np.asarray(
                            list(data[self.schema.pk.name]), np.uint64)
                        self.state.next_pk = max(self.state.next_pk,
                                                 int(pkv.max()) + 1)
                else:
                    rids = np.frombuffer(rec.data, np.uint64)
                    self.journal.delete(xid, rids)
                    self._tomb_version += 1
            if outcome.get(xid) == RecordType.COMMIT:
                self.journal.commit(xid)
            elif outcome.get(xid) == RecordType.ABORT:
                self.journal.abort(xid)


def _decode_u64_column(seg: Segment, name: str) -> np.ndarray:
    """Host decode of one narrow column (merge/bookkeeping path)."""
    from ..encode.schemes import Scheme
    col = seg.columns[name]
    out = np.empty(seg.nrows_total, np.uint64)
    off = 0
    for p, n in zip(col.packs, seg.nrows):
        n = int(n)
        out[off:off + n] = _decode_pack_u64(p, n)
        off += n
    return out


def _decode_pack_u64(p, n: int) -> np.ndarray:
    from ..encode.schemes import Scheme
    if p.scheme == Scheme.CONST:
        v = 0
        for l in range(p.values.shape[0]):
            v = (v << 32) | int(p.values[l, 0])
        return np.full(n, v, np.uint64)
    if p.scheme == Scheme.RAW:
        if p.values.shape[0] == 1:
            return p.values[0, :n].astype(np.uint64)
        return ((p.values[0, :n].astype(np.uint64) << np.uint64(32))
                | p.values[1, :n].astype(np.uint64))
    if p.scheme in (Scheme.BITPACK, Scheme.DELTA):
        vals = np.zeros(p.planes.shape[1] * 32, np.uint64)
        for b in range(p.width):
            bits = np.unpackbits(p.planes[b].view(np.uint8),
                                 bitorder="little").astype(np.uint64)
            vals |= bits << np.uint64(b)
        vals = vals[:n]
        if p.scheme == Scheme.DELTA:
            with np.errstate(over="ignore"):
                d = (vals >> np.uint64(1)) ^ \
                    (np.uint64(0) - (vals & np.uint64(1)))
                keys = np.cumsum(d.view(np.int64)).view(np.uint64) \
                    + np.uint64(p.min_key)
            return keys
        return vals + np.uint64(p.min_key)
    if p.scheme == Scheme.RLE:
        ends = p.ends[:max(1, p.card)]
        rv = p.values[:, :max(1, p.card)]
        if rv.shape[0] == 1:
            vals = rv[0].astype(np.uint64)
        else:
            vals = (rv[0].astype(np.uint64) << np.uint64(32)) | rv[1]
        idx = np.searchsorted(ends, np.arange(n), side="right")
        return vals[idx]
    if p.scheme == Scheme.DICT:
        codes = np.zeros(p.planes.shape[1] * 32, np.uint32)
        for b in range(p.width):
            bits = np.unpackbits(p.planes[b].view(np.uint8),
                                 bitorder="little").astype(np.uint32)
            codes |= bits << np.uint32(b)
        return p.dict_keys[codes[:n]] if p.dict_keys is not None else \
            _dict_vals(p)[codes[:n]]
    raise ValueError(p.scheme)


def _dict_vals(p) -> np.ndarray:
    if p.values.shape[0] == 1:
        return p.values[0].astype(np.uint64)
    return (p.values[0].astype(np.uint64) << np.uint64(32)) | p.values[1]


def _keys64_to_values(keys: np.ndarray, ft: FieldType) -> np.ndarray:
    """Vectorized u64 keyform -> native values (object ndarray of
    python scalars) — group/top-k output materialization without
    per-value python."""
    k = np.asarray(keys, np.uint64)
    if ft.nlimbs == 2:
        limbs = np.stack([(k >> np.uint64(32)).astype(np.uint32),
                          (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)])
    else:
        limbs = k.astype(np.uint32)[None]
    vals = lb.from_keyform(limbs, ft)
    return np.array(vals.tolist(), object)


def _combine_agg(op, vals, jval):
    vals = [v for v in vals if v is not None]
    if jval is not None:
        vals.append(jval)
    if not vals:
        return None if op in ("min", "max") else 0
    if op == "sum":
        return sum(vals)
    if op == "min":
        return min(vals)
    if op == "max":
        return max(vals)
    raise ValueError(op)
