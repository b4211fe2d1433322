"""knoxdb_tpu_torch's engine under threads, on the CPU: the single-writer
token, snapshot isolation of readers against inserts, background merges
and device-cache evictions, the lock manager and DDL waits (mirrors
tests/test_concurrency.py and the background-merge cases of
tests/test_advice_fixes.py). Tables are small: the tests check
interleavings, not speed."""

import threading
import time

import numpy as np
import pytest

from knoxdb_tpu_torch.engine.engine import (DeadlockError, Engine,
                                            LockManager, Options)
from knoxdb_tpu_torch.exec.scan import AggSpec
from knoxdb_tpu_torch.query.filter import Filter, leaf
from knoxdb_tpu_torch.schema.schema import Builder
from knoxdb_tpu_torch.types import FieldType, FilterMode


class Db:
    """One port table behind autocommit writes and snapshot reads."""

    def __init__(self, path, **opts):
        kw = dict(driver="file", pack_size=256, background_merge=False,
                  device="cpu")
        kw.update(opts)
        self.e = Engine("c", Options(path=str(path), **kw))
        sch = (Builder("r").pk("id").add("worker", FieldType.UINT64)
               .add("v", FieldType.INT64).finish())
        self.t = self.e.tables.get("r") or self.e.create_table(sch)

    def insert(self, worker, v):
        v = np.atleast_1d(np.asarray(v, np.int64))
        with self.e.begin() as tx:
            return self.t.insert_rows(tx, {
                "id": np.zeros(len(v), np.uint64),
                "worker": np.full(len(v), worker, np.uint64), "v": v})

    def tree(self, field, mode, value):
        return leaf(Filter(self.t.schema.field(field), FilterMode[mode],
                           value)).optimize()

    def delete(self, tree):
        with self.e.begin() as tx:
            return self.t.delete_rows(tx, tree)

    def query(self, tree=None, project=None):
        with self.e.begin(read_only=True) as tx:
            return self.t.query(tx.snapshot, tree,
                                [AggSpec("count"), AggSpec("sum", "v")],
                                project=project)

    def count(self, tree=None):
        return self.query(tree).count

    def close(self):
        self.e.close()


def _run(threads):
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)


def test_concurrent_writers(tmp_path):
    db = Db(tmp_path)
    NW, PER = 6, 20
    errs = []

    def writer(w):
        try:
            for i in range(PER):
                db.insert(w, i)
        except Exception as e:          # pragma: no cover
            errs.append(e)

    _run([threading.Thread(target=writer, args=(w,)) for w in range(NW)])
    assert not errs
    r = db.query(project=["id"])
    assert r.count == NW * PER and len(set(r.rows["id"].tolist())) == NW * PER
    for w in range(NW):
        assert db.count(db.tree("worker", "EQ", w)) == PER
    db.close()
    db2 = Db(tmp_path)
    assert db2.count() == NW * PER
    db2.close()


def test_readers_during_write(tmp_path):
    db = Db(tmp_path)
    db.insert(0, 1)
    stop = threading.Event()
    errs = []

    def reader():
        seen = 0
        try:
            while not stop.is_set():
                c = db.count()
                assert c >= max(seen, 1)
                seen = c
        except Exception as e:          # pragma: no cover
            errs.append(e)

    th = threading.Thread(target=reader)
    th.start()
    for i in range(30):
        db.insert(1, i)
    stop.set()
    th.join()
    assert not errs and db.count() == 31
    db.close()


def test_background_merge_vs_readers(tmp_path):
    """One query is one snapshot: count and sum always agree with whole
    batches, and counts never go backwards while merges swap segments
    under a tiny journal."""
    db = Db(tmp_path, pack_size=64, journal_size=128, background_merge=True)
    BATCH, NB = 50, 12
    stop = threading.Event()
    errs = []

    def reader():
        seen = 0
        try:
            while not stop.is_set():
                r = db.query()
                c, s = r.count, r.aggs[("sum", "v")]
                assert c % BATCH == 0 and c >= seen, (c, seen)
                assert s == (c // BATCH) * (BATCH * (BATCH - 1) // 2)
                seen = c
        except AssertionError as e:
            errs.append(e)

    rd = [threading.Thread(target=reader) for _ in range(2)]
    for th in rd:
        th.start()
    for _ in range(NB):
        db.insert(0, np.arange(BATCH))
    db.e.tasks.drain()
    stop.set()
    for th in rd:
        th.join()
    assert not errs, errs[:3]
    assert db.count() == BATCH * NB and db.t.metrics.merges > 0
    db.close()


def test_background_merge_deletes_never_reappear(tmp_path):
    db = Db(tmp_path, pack_size=64, journal_size=128, background_merge=True)
    db.insert(0, np.arange(300))
    db.e.tasks.drain()
    db.delete(db.tree("v", "LT", 100))
    stop = threading.Event()
    errs = []

    def reader():
        try:
            while not stop.is_set():
                assert db.count() in (200, 250)
                assert db.count(db.tree("v", "LT", 100)) == 0
        except AssertionError as e:
            errs.append(e)

    rd = [threading.Thread(target=reader) for _ in range(2)]
    for th in rd:
        th.start()
    for _ in range(5):
        db.insert(1, 1000 + np.arange(50))
        db.delete(db.tree("v", "GE", 1000))
    db.e.tasks.drain()
    stop.set()
    for th in rd:
        th.join()
    assert not errs, errs[:3]
    assert db.count() == 200
    db.close()


def test_eviction_under_concurrent_readers(tmp_path):
    """A one-byte device budget evicts on nearly every scan while merges
    swap segments underneath: results stay exact, no thread fails."""
    db = Db(tmp_path, driver="mem", background_merge=True,
            device_cache_bytes=1)
    n0 = 1000
    db.insert(0, np.arange(n0))
    db.t.merge()
    stop = threading.Event()
    errs = []

    def reader():
        try:
            while not stop.is_set():
                assert db.count() >= n0
                r = db.query(db.tree("v", "LT", 500))
                assert r.count == 500 and r.aggs[("sum", "v")] \
                    == sum(range(500))
        except Exception as e:          # pragma: no cover
            errs.append(e)

    rd = [threading.Thread(target=reader) for _ in range(3)]
    for th in rd:
        th.start()
    for i in range(8):
        db.insert(1, n0 + i)
        db.t.merge()
    stop.set()
    for th in rd:
        th.join()
    assert not errs, errs[:2]
    assert db.count() == n0 + 8
    assert db.e.cache.evictions > 0
    assert db.query().aggs[("sum", "v")] == sum(range(n0 + 8))
    db.close()


def test_lock_manager_shared_exclusive():
    lm = LockManager()
    lm.acquire(1, 100, exclusive=False)
    lm.acquire(1, 101, exclusive=False)
    got = []

    def want_excl():
        lm.acquire(1, 102, exclusive=True, timeout=5.0)
        got.append("excl")
        lm.release_all(102)

    th = threading.Thread(target=want_excl)
    th.start()
    time.sleep(0.05)
    assert got == []
    lm.release(1, 100)
    time.sleep(0.05)
    assert got == []
    lm.release(1, 101)
    th.join(timeout=5)
    assert got == ["excl"]


def test_lock_manager_reentrant_and_upgrade():
    lm = LockManager()
    lm.acquire(7, 1, exclusive=True)
    lm.acquire(7, 1, exclusive=True)
    lm.release(7, 1)
    lm.acquire(7, 1, exclusive=False)
    lm.release_all(1)
    lm.acquire(7, 2, exclusive=False)
    lm.acquire(7, 2, exclusive=True)
    lm.release_all(2)
    assert not lm._held


def test_lock_manager_deadlock_detected():
    lm = LockManager()
    lm.acquire(1, 10, exclusive=True)
    lm.acquire(2, 20, exclusive=True)
    errs = []

    def t10_wants_b():
        try:
            lm.acquire(2, 10, exclusive=True, timeout=5.0)
            lm.release(2, 10)
        except DeadlockError:
            errs.append("t10")
            lm.release_all(10)

    th = threading.Thread(target=t10_wants_b)
    th.start()
    time.sleep(0.1)
    with pytest.raises(DeadlockError):
        lm.acquire(1, 20, exclusive=True, timeout=5.0)
    lm.release_all(20)
    th.join(timeout=5)
    assert not errs
    lm.release_all(10)


def test_ddl_waits_for_write_tx(tmp_path):
    db = Db(tmp_path, driver="mem")
    db.insert(1, 1)
    tx = db.e.begin()
    db.t.insert_rows(tx, {"id": np.array([0], np.uint64),
                          "worker": np.array([2], np.uint64),
                          "v": np.array([2], np.int64)})
    done = []

    def dropper():
        db.e.drop_table("r")
        done.append(True)

    th = threading.Thread(target=dropper)
    th.start()
    time.sleep(0.1)
    assert not done
    tx.commit()
    th.join(timeout=5)
    assert done and "r" not in db.e.tables
    db.close()


def test_hammer_mixed_ops_background_merge(tmp_path):
    """Writers insert and delete while readers count and sum, under
    background merges; at quiesce the table equals the writers' logs."""
    db = Db(tmp_path, driver="mem", background_merge=True, journal_size=256)
    NW, ROUNDS = 3, 12
    logs = [[] for _ in range(NW)]
    errs = []
    stop = threading.Event()

    def writer(w):
        rng = np.random.default_rng(w)
        try:
            for i in range(ROUNDS):
                vals = rng.integers(0, 1000, int(rng.integers(5, 40)))
                pks = db.insert(w, vals)
                logs[w].append((pks.tolist(), vals.tolist()))
                if i % 5 == 3:
                    j = int(rng.integers(0, len(logs[w])))
                    if logs[w][j][0]:
                        db.delete(db.tree("id", "IN", logs[w][j][0]))
                        logs[w][j] = ([], [])
        except Exception as e:          # pragma: no cover
            errs.append(e)

    def reader():
        try:
            while not stop.is_set():
                r = db.query()
                assert r.count >= 0 and isinstance(r.aggs[("sum", "v")],
                                                   int)
        except Exception as e:          # pragma: no cover
            errs.append(e)

    ws = [threading.Thread(target=writer, args=(w,)) for w in range(NW)]
    rs = [threading.Thread(target=reader) for _ in range(2)]
    for th in ws + rs:
        th.start()
    for th in ws:
        th.join(timeout=120)
    stop.set()
    for th in rs:
        th.join(timeout=30)
    db.e.tasks.drain()
    assert not errs, errs[:3]
    db.t.merge()
    want = {p: v for w in range(NW) for pks, vals in logs[w]
            for p, v in zip(pks, vals)}
    r = db.query(project=["id", "v"])
    assert r.count == len(want)
    assert dict(zip(r.rows["id"].tolist(), r.rows["v"].tolist())) == want
    db.close()
