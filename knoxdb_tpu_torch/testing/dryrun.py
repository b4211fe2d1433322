"""The multi-shard dry run of the SDK (after knoxdb_tpu's
__graft_entry__.dryrun_multichip): one database, optionally mesh-attached,
answering a filter-tree + multi-aggregate query, a group-by, a time
series with var, ORDER BY with a limit, deletes and an incremental
merge with a re-query, and a join of two tables, each answer in a form
that compares by ==.

`knox` is the SDK module to drive (this package's, or any with the same
surface), so the same seeded calls run on a mesh-attached database and on
a plain one and their answers compare whole."""

from __future__ import annotations

import importlib
import time

import numpy as np

__all__ = ["dryrun_tables"]


def _lists(d: dict) -> dict:
    return {k: list(np.asarray(v, object)) for k, v in d.items()}


def dryrun_tables(knox, name: str, n: int = 16384, pack_size: int = 2048,
                  seed: int = 1, join_rows: int | None = None, **db_kw):
    """Run the dry run on a fresh database of `knox` (db_kw go to
    create_database: mesh=, device=, driver=...): n rows in the main
    table, join_rows (n by default) in the join's probe table and a
    sixteenth of them in its build table. Returns (answers, walls, db):
    answers a dict of the calls' results, walls each call's host seconds,
    and the database left open for the caller to inspect and close."""
    pkg = importlib.import_module(knox.__name__.rsplit(".", 1)[0])
    Builder = importlib.import_module(pkg.__name__ + ".schema.schema").Builder
    FT = importlib.import_module(pkg.__name__ + ".types").FieldType
    ser = importlib.import_module(pkg.__name__ + ".series")
    F = knox.F
    acct = (Builder("acct").pk("id").add("val", FT.UINT64)
            .add("bal", FT.INT64).add("grp", FT.UINT32)
            .add("ts", FT.UINT64).finish())
    rng = np.random.default_rng(seed)
    T0, IV, NB = 1_000_000, 512, 32
    data = {
        "id": np.zeros(n, np.uint64),
        "val": rng.integers(0, 50_000, n),
        # a range below 2^32 keeps the series moments on the exact route
        "bal": rng.integers(-1 << 29, 1 << 29, n),
        "grp": rng.integers(0, 16, n),
        "ts": (T0 + rng.integers(0, NB * IV, n)).astype(np.uint64),
    }
    db = knox.create_database(name, pack_size=pack_size,
                              background_merge=False, **db_kw)
    walls, out = {}, {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out[key] = fn()
        walls[key] = time.perf_counter() - t0

    t = db.create_table(acct)
    timed("insert", lambda: t.insert({k: v.copy() for k, v in data.items()}))
    timed("merge", t.merge)
    out.pop("insert"), out.pop("merge")
    timed("aggregate", lambda: t.query().where(
        F("val").between(1000, 40_000), F("bal") > 0).aggregate(
        ("count", ""), ("sum", "bal"), ("min", "bal"), ("max", "val")))
    timed("group_by", lambda: _lists(
        t.query().where(F("val") > 500).group_by("grp").aggregate(
            ("count", ""), ("sum", "bal"))))
    timed("run_series", lambda: _lists(ser.run_series(ser.SeriesRequest(
        table=t, time_field="ts", start=T0, end=T0 + NB * IV, interval=IV,
        aggs=[("sum", "bal"), ("var", "bal")]))))
    timed("order_by", lambda: _lists(
        t.query().order_by("bal").limit(50).select("bal", "val").rows()))
    del_rng = np.random.default_rng(99)
    del_pks = [int(x) for x in
               np.unique(del_rng.integers(1, n, 300, dtype=np.uint64))]
    timed("delete", lambda: t.delete(t.query().where(F("id").in_(del_pks))))
    timed("merge_incremental", t.merge)
    out.pop("merge_incremental")
    timed("requery", lambda: t.query().where(
        F("val").between(1000, 40_000), F("bal") > 0).aggregate(
        ("count", ""), ("sum", "bal")))

    # a join of two tables of the same database (knox.join; on a
    # mesh-attached database its shuffle branch)
    nt = join_rows or n
    na = max(nt // 16, 1)
    accts = db.create_table(Builder("xa").pk("id").add("code", FT.UINT64)
                            .finish())
    txns = db.create_table(Builder("xt").pk("id").add("acct", FT.UINT64)
                           .add("amt", FT.INT64).finish())
    accts.insert({"id": np.zeros(na, np.uint64),
                  "code": np.arange(na, dtype=np.uint64) * 3})
    txns.insert({"id": np.zeros(nt, np.uint64),
                 "acct": rng.integers(1, na * 2, nt).astype(np.uint64),
                 "amt": rng.integers(-100, 100, nt)})
    accts.merge()
    txns.merge()

    def join():
        j = knox.join(txns.query().where(F("amt") > 50), accts.query(),
                      on=("acct", "id"))
        return (int(j["__n"]), sorted(zip((int(a) for a in j["amt"]),
                                          (int(c) for c in j["code"]))))
    timed("join", join)
    return out, walls, db
