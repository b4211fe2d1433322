"""Engine: database lifecycle, catalog, MVCC transactions, tasks, WAL GC.

The port of knoxdb_tpu/engine/engine.py. Its tables scan their sealed
segments on one torch device, `Options.device`: "cuda" (the default) or
whatever the caller names, "cpu" included. A CUDA engine on a machine
without a card raises at construction; nothing moves to the CPU.

Mirrors the upstream engine core (internal/engine/
engine.go:62-85, tx.go, catalog.go, lock.go, task.go) on the host side:

- single-writer / multi-reader MVCC: one write token, monotonic XIDs,
  read snapshots {xown, xmin, xmax, xact} (internal/types/snapshot.go)
- commit = WAL commit record (sync/nosync) -> per-table CommitTx ->
  merge scheduling (tx.go:328-445)
- catalog: object registry + table state persisted in the store
- TaskService: background worker pool for merges (task.go:103-210)
- checkpoint watermark = min over table checkpoints drives wal.gc
  (engine.go:734-867)
"""

from __future__ import annotations

import json
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path

import torch

from ..schema.schema import Schema
from ..store.kv import Store, create_store
from ..types import Snapshot
from ..wal.wal import Record, RecordType, Wal
from .table import Table

__all__ = ["Engine", "Tx", "Options"]


@dataclass
class Options:
    driver: str = "mem"              # mem | file
    path: str | None = None
    pack_size: int = 1 << 16
    journal_size: int = 1 << 17
    wal_sync: str = "sync"           # sync | delay | nosync
    background_merge: bool = True
    device_cache_bytes: int = 8 << 30   # device residency budget for segments
    # the torch device every segment of the engine uploads to and scans
    # on (runtime-only, not persisted)
    device: str = "cuda"
    # parallel.Mesh for pack-parallel scans and shuffle joins (runtime-
    # only, not persisted); None = the engine's one device
    mesh: object = None


class CacheManager:
    """Device-residency budget for uploaded segments — SCAN-RESISTANT
    2Q (reference engine.go:87-94 block/buffer CacheManager backed
    by the refcounted 2Q of pkg/cache/rclru/2q.go:22-26): segments
    upload lazily; above the byte budget eviction drops a handle's
    device image (host arrays stay — re-upload on next use).

    2Q policy: first-touch handles enter a bounded PROBATION fifo
    (A1in, 25% of the budget); only a RE-reference promotes to the
    protected LRU (Am). A one-pass full-table scan therefore cycles
    probation and can never evict another table's re-referenced hot
    set — the exact property rclru's 2Q buys the reference. A ghost
    list (A1out, ids only) promotes recently-demoted entries straight
    to Am on their next touch."""

    PROBATION_FRAC = 0.25          # rclru 2q.go: A1in sized at 25%
    GHOSTS = 256                   # A1out id capacity

    def __init__(self, budget_bytes: int = 8 << 30):
        self.budget = budget_bytes
        self._clock = 0
        # id -> (handle, bytes, last_use); insertion order = fifo age
        self._prob: dict[int, tuple] = {}
        self._hot: dict[int, tuple] = {}
        self._ghost: dict[int, int] = {}     # id -> demote clock
        self._mu = threading.Lock()          # readers + merge workers race
        self.evictions = 0
        self.hits = 0
        self.misses = 0

    def _evict(self, keep: int) -> None:
        """Drop device images until under budget (never the just-touched
        `keep`). Probation first (fifo), then protected LRU."""
        def total():
            return (sum(b for _, b, _ in self._prob.values())
                    + sum(b for _, b, _ in self._hot.values()))
        prob_budget = self.budget * self.PROBATION_FRAC
        while len(self._prob) + len(self._hot) > 1:
            over = total() > self.budget
            prob_over = sum(b for _, b, _ in self._prob.values()) \
                > prob_budget and len(self._prob) > 1
            if not over and not prob_over:
                break
            pool = self._prob if (self._prob and (prob_over or over)) \
                else self._hot
            victim = None
            if pool is self._prob:       # fifo: oldest insertion first
                for k in pool:
                    if k != keep:
                        victim = k
                        break
            else:                        # protected: LRU
                victim = min((k for k in pool if k != keep),
                             key=lambda k: pool[k][2], default=None)
            if victim is None:
                break
            h, b, _ = pool.pop(victim)
            self._ghost[victim] = self._clock
            while len(self._ghost) > self.GHOSTS:
                self._ghost.pop(next(iter(self._ghost)))
            # a thread mid-scan keeps its scanner alive via its own
            # reference; dropping here only forces a later re-upload
            h.dseg = None
            h.scanner = None
            self.evictions += 1

    def note_use(self, handle) -> None:
        with self._mu:
            self._clock += 1
            key = id(handle)
            if key in self._hot:
                h, b, _ = self._hot[key]
                self._hot[key] = (h, b, self._clock)
                self.hits += 1
                return
            if key in self._prob:        # second touch -> protected
                h, b, _ = self._prob.pop(key)
                self._hot[key] = (h, b, self._clock)
                self.hits += 1
                self._evict(key)
                return
            self.misses += 1
            nbytes = handle.seg.nbytes
            if self._ghost.pop(key, None) is not None:
                self._hot[key] = (handle, nbytes, self._clock)
            else:
                self._prob[key] = (handle, nbytes, self._clock)
            self._evict(key)

    def drop(self, handle) -> None:
        with self._mu:
            self._prob.pop(id(handle), None)
            self._hot.pop(id(handle), None)
            self._ghost.pop(id(handle), None)


class TaskService:
    """Background worker pool (synchronous fallback when disabled)."""

    def __init__(self, workers: int = 2, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._pending: list = []
        self._threads: list[threading.Thread] = []
        self._stop = False
        self._cv = threading.Condition(self._lock)
        if enabled:
            for _ in range(workers):
                t = threading.Thread(target=self._run, daemon=True)
                t.start()
                self._threads.append(t)

    def submit(self, fn) -> None:
        if not self.enabled:
            fn()
            return
        with self._cv:
            self._pending.append(fn)
            self._cv.notify()

    def drain(self) -> None:
        while True:
            with self._cv:
                if not self._pending and not getattr(self, "_active", 0):
                    return
            threading.Event().wait(0.01)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait(0.1)
                if self._stop:
                    return
                fn = self._pending.pop(0)
                self._active = getattr(self, "_active", 0) + 1
            try:
                fn()
            finally:
                with self._cv:
                    self._active -= 1

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()


class DeadlockError(RuntimeError):
    """A lock acquire would close a wait-for cycle (reference
    engine.ErrDeadlock, lock.go:526). The REQUESTER is the victim —
    abort its tx and retry."""


class LockManager:
    """Shared/exclusive object locks with WAIT-FOR-GRAPH deadlock
    detection (reference internal/engine/lock.go:272,343,526).

    acquire() blocks until compatible; before each wait it walks the
    wait-for graph (waiter -> current holders of its wanted object) and
    raises DeadlockError if the requester is on a cycle. Re-entrant per
    (oid, xid); a holder's shared lock upgrades in place when no other
    holders remain."""

    def __init__(self):
        self._cv = threading.Condition()
        # oid -> {xid: (exclusive, count)}
        self._held: dict[int, dict[int, list]] = {}
        self._waiting: dict[int, tuple[int, bool]] = {}  # xid -> (oid, excl)

    def _compatible(self, oid: int, xid: int, excl: bool) -> bool:
        others = {x: m for x, m in self._held.get(oid, {}).items()
                  if x != xid}
        if excl:
            return not others
        return not any(m[0] for m in others.values())

    def _on_cycle(self, xid: int) -> bool:
        seen: set[int] = set()
        stack = [h for h in self._holders_of(self._waiting[xid][0], xid)]
        while stack:
            x = stack.pop()
            if x == xid:
                return True
            if x in seen or x not in self._waiting:
                continue
            seen.add(x)
            stack.extend(self._holders_of(self._waiting[x][0], x))
        return False

    def _holders_of(self, oid: int, but: int) -> list[int]:
        return [x for x in self._held.get(oid, {}) if x != but]

    def acquire(self, oid: int, xid: int, exclusive: bool = False,
                timeout: float = 10.0) -> None:
        with self._cv:
            ent = self._held.get(oid, {}).get(xid)
            if ent is not None and (ent[0] or not exclusive):
                ent[1] += 1                      # re-entrant / downgrade-noop
                return
            while not self._compatible(oid, xid, exclusive):
                self._waiting[xid] = (oid, exclusive)
                if self._on_cycle(xid):
                    del self._waiting[xid]
                    raise DeadlockError(
                        f"deadlock: tx {xid} -> object {oid}")
                if not self._cv.wait(timeout=timeout):
                    del self._waiting[xid]
                    raise TimeoutError(
                        f"lock timeout: tx {xid} -> object {oid}")
            self._waiting.pop(xid, None)
            if ent is not None:                  # shared -> exclusive
                ent[0] = True
                ent[1] += 1
            else:
                self._held.setdefault(oid, {})[xid] = [exclusive, 1]

    def release(self, oid: int, xid: int) -> None:
        with self._cv:
            ent = self._held.get(oid, {}).get(xid)
            if ent is None:
                return
            ent[1] -= 1
            if ent[1] <= 0:
                del self._held[oid][xid]
                if not self._held[oid]:
                    del self._held[oid]
            self._cv.notify_all()

    def release_all(self, xid: int) -> None:
        with self._cv:
            for oid in list(self._held):
                if xid in self._held[oid]:
                    del self._held[oid][xid]
                    if not self._held[oid]:
                        del self._held[oid]
            self._cv.notify_all()


class Tx:
    """MVCC transaction (reference internal/engine/tx.go:56-68)."""

    def __init__(self, engine: "Engine", xid: int, snapshot: Snapshot,
                 read_only: bool = False):
        self.engine = engine
        self.xid = xid
        self.snapshot = snapshot
        self.read_only = read_only
        self.touched: list[Table] = []
        self.closed = False

    def touch(self, table: Table) -> None:
        if table not in self.touched:
            # exclusive object lock held to commit/abort (reference
            # lock.go write-tx object locks); DDL waits on it. Readers
            # stay lock-free: MVCC snapshots + python refs keep dropped
            # tables alive for in-flight queries.
            self.engine.locks.acquire(table.id, self.xid, exclusive=True)
            self.touched.append(table)

    def commit(self) -> None:
        if self.closed:
            return
        if not self.read_only and self.touched:
            rec = Record(RecordType.COMMIT, 0, self.xid)
            mode = self.engine.opts.wal_sync
            if mode == "sync":
                self.engine.wal.write_and_sync(rec)
            elif mode == "delay":
                # group commit: block on the shared background fsync
                self.engine.wal.write_delayed(rec).wait(timeout=5.0)
            else:
                self.engine.wal.write(rec)
            for t in self.touched:
                t.commit_tx(self.xid)
        self.engine._finish_tx(self)
        self.closed = True

    def abort(self) -> None:
        if self.closed:
            return
        if not self.read_only and self.touched:
            self.engine.wal.write(Record(RecordType.ABORT, 0, self.xid))
            for t in self.touched:
                t.abort_tx(self.xid)
        self.engine._finish_tx(self)
        self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            self.commit()
        else:
            self.abort()


class Engine:
    def __init__(self, name: str, opts: Options | None = None):
        self.name = name
        self.opts = opts or Options()
        self.device = torch.device(self.opts.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"engine {name}: device {self.opts.device!r} asked for, "
                f"but torch.cuda.is_available() is False; pass "
                f"Options(device='cpu') to run on the CPU")
        self.mesh = self.opts.mesh
        root = Path(self.opts.path or Path(tempfile.gettempdir())
                    / "knoxdb_tpu_torch" / name)
        if self.opts.driver == "file":
            root.mkdir(parents=True, exist_ok=True)
            self.store: Store | None = create_store("file", root / "data")
        else:
            self.store = create_store("mem")
        self.wal = Wal(root / "wal", sync=self.opts.wal_sync
                       if self.opts.wal_sync == "delay" else "sync")
        from .enum import EnumRegistry
        self.enums = EnumRegistry()
        self.tables: dict[str, Table] = {}
        self._table_ids: dict[int, Table] = {}
        self.tasks = TaskService(enabled=self.opts.background_merge)
        self.locks = LockManager()
        self.cache = CacheManager(self.opts.device_cache_bytes)
        self._xid = 1
        self._active: set[int] = set()
        self._write_token = threading.Lock()
        self._mu = threading.Lock()
        self._next_oid = 1
        self._next_ddl_id = 1 << 40          # above any realistic xid
        self._load_catalog()

    # ----------------------------------------------------------- catalog --

    def create_table(self, schema: Schema, *, pack_size: int | None = None,
                     journal_size: int | None = None,
                     history: bool = False) -> Table:
        if schema.name in self.tables:
            raise ValueError(f"table {schema.name} exists")
        oid = self._next_oid
        self._next_oid += 1
        t = Table(self, oid, schema,
                  pack_size=pack_size or self.opts.pack_size,
                  journal_size=journal_size or self.opts.journal_size,
                  history=history)
        self.tables[schema.name] = t
        self._table_ids[oid] = t
        self._save_catalog()
        return t

    def history_table_for(self, t: Table) -> Table:
        """Shadow table receiving dying row versions (reference 'history'
        table kind, internal/pack/table/table.go:27-30): user fields (pk
        demoted to a plain column) + $src_rid/$src_xmin/$del_xid."""
        if t.history_table is not None:
            return t.history_table
        import dataclasses as _dc
        from ..schema.schema import Field as _F
        from ..types import FieldType as _FT
        name = f"{t.schema.name}_history"
        if name in self.tables:
            t.history_table = self.tables[name]
            return t.history_table
        fields = [_F("hid", _FT.UINT64, is_pk=True)]
        for f in t.schema.fields:
            fields.append(_dc.replace(f, id=0, is_pk=False,
                                      index=f.index.__class__(0)))
        for extra in ("$src_rid", "$src_xmin", "$del_xid"):
            fields.append(_F(extra, _FT.UINT64))
        h = self.create_table(Schema(name, fields),
                              pack_size=t.pack_size)
        t.history_table = h
        return h

    def _ddl_lock(self, oid: int) -> int:
        """Exclusive object lock for a DDL op under a synthetic lock id
        (above the xid space) — waits out any write tx touching the
        table; DeadlockError cannot fire (DDL holds a single lock)."""
        with self._mu:
            lid = self._next_ddl_id
            self._next_ddl_id += 1
        self.locks.acquire(oid, lid, exclusive=True)
        return lid

    def drop_table(self, name: str) -> None:
        t = self.tables.get(name)
        if t is None:
            raise KeyError(name)
        lid = self._ddl_lock(t.id)
        try:
            self.tables.pop(name, None)
            self._table_ids.pop(t.id, None)
            if self.store:
                self.store.drop_bucket(f"table_{t.id}_segments")
            self._save_catalog()
        finally:
            self.locks.release_all(lid)

    def truncate_table(self, name: str) -> None:
        """Drop all rows of a table, keeping its schema and indexes
        (reference engine.TruncateTable)."""
        t = self.table(name)
        lid = self._ddl_lock(t.id)
        try:
            t.truncate()
        finally:
            self.locks.release_all(lid)

    def compact_table(self, name: str) -> None:
        """Force journal merge + segment compaction (reference
        engine.CompactTable — merge IS the compaction here)."""
        t = self.table(name)
        lid = self._ddl_lock(t.id)
        try:
            t.merge()
        finally:
            self.locks.release_all(lid)

    def alter_table(self, name: str, schema) -> None:
        """Schema evolution — NOT IMPLEMENTED, matching the reference
        exactly (engine/table.go:155-203 returns ErrNotImplemented with
        the same documented change contract)."""
        raise NotImplementedError(
            "alter_table: not implemented (reference parity — "
            "engine/table.go:202 ErrNotImplemented)")

    def table(self, name: str) -> Table:
        return self.tables[name]

    def _save_catalog(self) -> None:
        if self.store is None:
            return
        b = self.store.bucket("catalog")
        cat = {
            "next_oid": self._next_oid,
            "enums": self.enums.to_dict(),
            "tables": [{
                "id": t.id, "schema": t.schema.to_dict(),
                "pack_size": t.pack_size,
                "state": t.state.to_dict(),
                "history": t.history_enabled,
                # segment-blob manifest: saved atomically WITH the
                # checkpoint LSN so crash recovery always sees a matched
                # (segments, replay-start) pair
                "segkeys": t._seg_keys,
                "segdead": t._seg_dead,
                "next_blob": t._next_blob,
            } for t in self.tables.values()],
        }
        b.put(b"catalog", json.dumps(cat).encode())

    def save_state(self, t: Table) -> None:
        self._save_catalog()
        self.try_gc()

    def _load_catalog(self) -> None:
        if self.store is None:
            return
        b = self.store.bucket("catalog")
        raw = b.get(b"catalog")
        if not raw:
            return
        cat = json.loads(raw)
        self._next_oid = cat["next_oid"]
        if cat.get("enums"):
            from .enum import EnumRegistry
            self.enums = EnumRegistry.from_dict(cat["enums"])
        from .table import TableState
        for td in cat["tables"]:
            sch = Schema.from_dict(td["schema"])
            t = Table(self, td["id"], sch, pack_size=td["pack_size"],
                      journal_size=self.opts.journal_size,
                      history=td.get("history", False))
            t.state = TableState.from_dict(td["state"])
            t._seg_keys = td.get("segkeys", [])
            t._seg_dead = td.get("segdead", {})
            t._next_blob = td.get("next_blob", 0)
            t.load_segments()
            t.replay_wal()
            self.tables[sch.name] = t
            self._table_ids[td["id"]] = t
            self._xid = max(self._xid, self._max_replayed_xid() + 1)

    def _max_replayed_xid(self) -> int:
        from ..wal.wal import RecoveryMode
        mx = 0
        for rec in self.wal.records(mode=RecoveryMode.SKIP):
            mx = max(mx, rec.txid)
        return mx

    # -------------------------------------------------------------- txns --

    def begin(self, read_only: bool = False) -> Tx:
        """Single-writer / multi-reader (reference engine.go:75 write
        token channel): a write tx blocks here until the current writer
        commits or aborts; readers never block."""
        if not read_only:
            self._write_token.acquire()
        with self._mu:
            if read_only:
                snap = Snapshot(xown=0, xmin=0, xmax=self._xid,
                                xact=frozenset(self._active))
                return Tx(self, 0, snap, read_only=True)
            xid = self._xid
            self._xid += 1
            self._active.add(xid)
            snap = Snapshot(xown=xid, xmin=min(self._active, default=xid),
                            xmax=self._xid,
                            xact=frozenset(self._active - {xid}))
            return Tx(self, xid, snap)

    def _finish_tx(self, tx: Tx) -> None:
        with self._mu:
            self._active.discard(tx.xid)
        if not tx.read_only:
            self.locks.release_all(tx.xid)
            self._write_token.release()

    def view(self) -> Tx:
        return self.begin(read_only=True)

    # ---------------------------------------------------------------- gc --

    def try_gc(self) -> None:
        """Drop WAL segments below the min table checkpoint watermark."""
        if not self.tables:
            return
        marks = [t.state.checkpoint_lsn for t in self.tables.values()]
        pending = [t for t in self.tables.values()
                   if not t.journal.is_empty()]
        if pending:
            return
        self.wal.gc(min(marks))

    def close(self) -> None:
        self.tasks.drain()
        self.tasks.stop()
        self._save_catalog()
        self.wal.close()
        if self.store:
            self.store.close()
