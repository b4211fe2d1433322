"""knoxdb_tpu_torch.knox.join against knoxdb_tpu.knox.join (the SDK cases
of tests/test_join.py and more): the device path (INNER on a unique
build, the pk; LEFT on a non-unique one; keys32 and not), the host path
(RIGHT, FULL, CROSS; a string key; mixed signedness), select= pushdown,
where= under SQL three-valued logic with outer-miss None, and limit=.
Join pair order and the rows a limit keeps are unspecified upstream, so
results compare as multisets, and a limited result by its length and as
a subset of the unlimited one. The port runs on the CPU.

knoxdb_tpu compiles its device join cores for each pair of key counts, so
every device-path join here runs on the same unfiltered tables (512
probe rows, 64 build rows) and varies by post-join where= and limit=."""

from dataclasses import dataclass

import numpy as np
import pytest

from torch_knox_pair import SDK, SIDES, both, create, multiset

NA, NT, NHIT = 64, 512, 56      # accounts 57..64 have no transaction
SEED = 0x10A7


def _data():
    rng = np.random.default_rng(SEED)
    return {"aid": rng.integers(1, NHIT + 1, NT).astype(np.uint64),
            "amt": rng.integers(-1000, 1000, NT),
            "a32": rng.integers(1, NA + 1, NT).astype(np.uint32),
            "amt32": rng.integers(-100, 100, NT)}


def _tables(knox, db, d, merge=True):
    """accounts / txns with UINT64 keys, the keys32 pair with UINT32 keys
    and the shadowing pair: the same key counts on every device path."""
    FT = knox.FieldType
    B = knox.Builder
    t = {"accts": db.create_table(B("da").pk("id").add("code", FT.UINT64)
                                  .finish()),
         "txns": db.create_table(B("dt").pk("id").add("acct", FT.UINT64)
                                 .add("amount", FT.INT64).finish()),
         "ka": db.create_table(B("ka").pk("id").add("id32", FT.UINT32)
                               .add("code", FT.UINT64).finish()),
         "kt": db.create_table(B("kt").pk("id").add("acct", FT.UINT32)
                               .add("amount", FT.INT64).finish()),
         "wl": db.create_table(B("wl").pk("id").add("k", FT.UINT64)
                               .add("score", FT.INT64).finish()),
         "wr": db.create_table(B("wr").pk("id").add("score", FT.INT64)
                               .finish())}
    z = np.zeros(NA, np.uint64)
    t["accts"].insert({"id": z, "code": np.arange(NA, dtype=np.uint64) * 11})
    t["txns"].insert({"id": np.zeros(NT, np.uint64), "acct": d["aid"],
                      "amount": d["amt"]})
    t["ka"].insert({"id": z, "id32": np.arange(1, NA + 1, dtype=np.uint32),
                    "code": np.arange(NA, dtype=np.uint64) * 7})
    t["kt"].insert({"id": np.zeros(NT, np.uint64), "acct": d["a32"],
                    "amount": d["amt32"]})
    k = (np.arange(NT, dtype=np.uint64) % NA) + 1
    t["wl"].insert({"id": np.zeros(NT, np.uint64), "k": k,
                    "score": np.full(NT, -5, np.int64)})
    ids = np.arange(1, NA + 1, dtype=np.uint64)
    t["wr"].insert({"id": ids, "score": ids.astype(np.int64) * 10})
    if merge:
        for tab in t.values():
            tab.merge()
    return t


@pytest.fixture(scope="module")
def w():
    """Both packages' databases, built once for the module."""
    d = _data()
    out = {}
    for side in SIDES:
        db = create(side, "j", driver="mem", pack_size=256,
                    background_merge=False)
        out[side] = (db, _tables(SDK[side], db, d))
    yield d, out
    for db, _ in out.values():
        db.close()


def _limited(res, full):
    """A limited join: (its length, whether its rows lie in `full`)."""
    got = multiset(res)
    rest = list(full)
    for r in got:
        if r not in rest:
            return len(got), False
        rest.remove(r)
    return len(got), True


def test_device_inner_unique_where_limit_select(w):
    d, dbs = w

    def case(side, knox):
        t = dbs[side][1]
        F, tx, ac = knox.F, t["txns"], t["accts"]
        on = ("acct", "id")
        full = multiset(knox.join(tx.query(), ac.query(), on=on))
        where_or = ("or", F("amount") > 900, F("amount") < -900)
        full_or = multiset(knox.join(tx.query(), ac.query(), on=on,
                                     where=where_or))
        out = {
            "full": full, "or": full_or,
            "both_sides": multiset(knox.join(
                tx.query(), ac.query(), on=on,
                where=[F("amount") > 0, F("code") >= 33])),
            "or_limit": _limited(knox.join(tx.query(), ac.query(), on=on,
                                           where=where_or, limit=5),
                                 full_or),
            "limit": _limited(knox.join(tx.query(), ac.query(), on=on,
                                        limit=7), full),
            "select": knox.join(tx.query(), ac.query(), on=on,
                                select=("amount", "code")),
            "pruned": knox.join(tx.query(), ac.query(), on=on,
                                select=("code",), where=F("amount") > 0),
        }
        for k in ("select", "pruned"):
            out[k] = (sorted(out[k]), multiset(out[k]))
        with pytest.raises(KeyError):
            knox.join(tx.query(), ac.query(), on=on, select=("nope",))
        with pytest.raises(KeyError):
            knox.join(tx.query(), ac.query(), on=on, where=F("nope") == 1)
        return out
    out = both(case)
    aid, amt = d["aid"], d["amt"]
    assert len(out["full"]) == NT
    # rows: (acct, amount, code, id, r_id) in the order of their names
    got = sorted((r[1][2], r[2][2]) for r in out["full"])
    assert got == sorted((int(a), int(k - 1) * 11) for a, k in zip(amt, aid))
    m = (amt > 0) & ((aid - 1) * 11 >= 33)
    assert len(out["both_sides"]) == int(m.sum())
    assert len(out["or"]) == int(((amt > 900) | (amt < -900)).sum())
    assert out["or_limit"] == (5, True) and out["limit"] == (7, True)
    assert out["select"][0] == ["__n", "amount", "code"]
    assert out["pruned"][0] == ["__n", "code"]
    assert len(out["pruned"][1]) == int((amt > 0).sum())


def test_device_left_non_unique(w):
    d, dbs = w

    def case(side, knox):
        t = dbs[side][1]
        F, tx, ac = knox.F, t["txns"], t["accts"]
        on = ("id", "acct")
        return {
            "left": multiset(knox.join(ac.query(), tx.query(), on=on,
                                       how="left")),
            "ne": multiset(knox.join(ac.query(), tx.query(), on=on,
                                     how="left",
                                     where=F("amount") != 12345)),
            "not_eq": multiset(knox.join(
                ac.query(), tx.query(), on=on, how="left",
                where=("not", F("amount") == int(d["amt"][0])))),
            "limit": knox.join(ac.query(), tx.query(), on=on, how="left",
                               limit=9)["__n"],
        }
    out = both(case)
    assert len(out["left"]) == NT + (NA - NHIT)
    assert sum(1 for r in out["left"] if r[0] == (0, "")) == NA - NHIT
    assert len(out["ne"]) == NT                 # outer misses drop
    assert len(out["not_eq"]) == NT - int((d["amt"] == d["amt"][0]).sum())
    assert out["limit"] == 9


def test_device_keys32_and_journal_overlay(w):
    d, dbs = w

    def case(side, knox):
        t = dbs[side][1]
        k32 = multiset(knox.join(t["kt"].query(), t["ka"].query(),
                                 on=("acct", "id32"),
                                 where=knox.F("amount") > 0))
        # the probe side in the journal, the build side sealed
        db = create(side, "jo", driver="mem", pack_size=256,
                    background_merge=False)
        t2 = _tables(knox, db, d, merge=False)
        t2["accts"].merge()
        overlay = multiset(knox.join(t2["txns"].query(),
                                     t2["accts"].query(), on=("acct", "id"),
                                     where=knox.F("amount") < 0))
        db.close()
        return k32, overlay
    k32, overlay = both(case)
    m = d["amt32"] > 0
    got = sorted((r[1][2], r[2][2]) for r in k32)
    assert got == sorted((int(a), (int(k) - 1) * 7)
                         for a, k in zip(d["amt32"][m], d["a32"][m]))
    assert len(overlay) == int((d["amt"] < 0).sum())


def test_device_fetches_only_matched_rows(w):
    """The port's device path materializes only matched rows: the probe
    table's queried_tuples grow by about the match count."""
    d, dbs = w
    import knoxdb_tpu_torch.knox as knox
    t = dbs["port"][1]
    before = t["txns"]._t.metrics.queried_tuples
    out = knox.join(t["txns"].query().where(knox.F("amount") == 5),
                    t["accts"].query(), on=("acct", "id"))
    fetched = t["txns"]._t.metrics.queried_tuples - before
    n = int((d["amt"] == 5).sum())
    assert out["__n"] == n and fetched <= n + 64


def test_post_join_where_shadowing_and_3vl(w):
    """A right-side output column shadowed by an UNSELECTED left-schema
    column filters the right values on both paths; ('not', EQ) agrees
    with NE on outer-miss rows; a bogus r_ prefix raises; where=[] keeps
    every row."""
    d, dbs = w
    lk = (np.arange(NT) % NA) + 1

    def case(side, knox):
        db, t = dbs[side]
        F, wl, wr = knox.F, t["wl"], t["wr"]
        out = {h: multiset(knox.join(wl.query().select("k"), wr.query(),
                                     on=("k", "id"), how=h,
                                     where=F("score") > 500))
               for h in ("inner", "full")}
        out["unselected_left"] = multiset(knox.join(
            wl.query().select("k"), wr.query().select("id"),
            on=("k", "id"), where=F("score") < 0))
        # mixed signedness (UINT64 k, INT64 kk): the host path
        if "wr2" not in db.engine.tables:
            rt2 = db.create_table(knox.Builder("wr2").pk("id")
                                  .add("kk", knox.FieldType.INT64)
                                  .add("rv", knox.FieldType.INT64).finish())
            rt2.insert({"id": np.zeros(8, np.uint64),
                        "kk": np.arange(1, 9, dtype=np.int64),
                        "rv": np.arange(8, dtype=np.int64)})
            rt2.merge()
        rt2 = db.table("wr2")
        out["ne"] = multiset(knox.join(wl.query().select("k"), rt2.query(),
                                       on=("k", "kk"), how="left",
                                       where=F("rv") != 5))
        out["not_eq"] = multiset(knox.join(
            wl.query().select("k"), rt2.query(), on=("k", "kk"),
            how="left", where=("not", F("rv") == 5)))
        with pytest.raises(KeyError):
            knox.join(wl.query().select("k"), rt2.query(), on=("k", "kk"),
                      where=F("r_rv") > 3)
        out["empty_where"] = len(multiset(knox.join(
            wl.query().select("k"), rt2.query(), on=("k", "kk"),
            where=[])))
        return out
    out = both(case)
    n = int((lk * 10 > 500).sum())
    assert len(out["inner"]) == len(out["full"]) == n
    assert all(r[2][2] > 500 for r in out["inner"])   # (id, k, score)
    assert len(out["unselected_left"]) == NT
    assert out["ne"] == out["not_eq"]
    assert len(out["ne"]) == int(((lk <= 8) & (lk != 6)).sum())
    assert out["empty_where"] == int((lk <= 8).sum())


def test_host_path_right_full_cross(w):
    d, dbs = w

    def case(side, knox):
        t = dbs[side][1]
        F, tx, ac = knox.F, t["txns"], t["accts"]
        full = multiset(knox.join(ac.query(), tx.query(),
                                  on=("id", "acct"), how="full"))
        return {
            "full": full,
            "full_where": multiset(knox.join(
                ac.query(), tx.query().where(F("amount") > 800),
                on=("id", "acct"), how="full", where=F("amount") > 900)),
            "full_limit": _limited(knox.join(ac.query(), tx.query(),
                                             on=("id", "acct"),
                                             how="full", limit=3), full),
            "right": multiset(knox.join(
                tx.query().where(F("amount") > 500), ac.query(),
                on=("acct", "id"), how="right")),
            "right_where": multiset(knox.join(
                tx.query().where(F("amount") > 500), ac.query(),
                on=("acct", "id"), how="right",
                where=("not", F("amount") > 700))),
            "cross": multiset(knox.join(
                ac.query().where(F("code") < 33),
                tx.query().where(F("amount") > 990),
                on=("id", "acct"), how="cross")),
        }
    out = both(case)
    amt, aid = d["amt"], d["aid"]
    assert len(out["full"]) == NT + NA - NHIT
    assert len(out["full_where"]) == int((amt > 900).sum())
    assert out["full_limit"] == (3, True)
    hit = {int(a) for a in aid[amt > 500]}
    assert len(out["right"]) == int((amt > 500).sum()) + sum(
        1 for i in range(1, NA + 1) if i not in hit)
    assert len(out["cross"]) == 3 * int((amt > 990).sum())


@dataclass
class Account:
    id: int = 0
    name_code: int = 0


@dataclass
class Txn:
    id: int = 0
    acct: int = 0
    amount: int = 0


def test_mixed_signedness_and_string_key(rng):
    """A UINT64 pk against an INT64 fk (dataclass tables) and a STRING
    key: the host path, exact python ints and bytes."""
    aid = rng.integers(1, 21, 300)
    amt = rng.integers(-1000, 1000, 300)
    names = ["ares", "boreas", "chronos", "demeter", "eos"]
    tag = [names[int(i)] for i in rng.integers(0, 5, 60)]
    wv = rng.integers(-9, 9, 60).astype(np.int32)

    def case(side, knox):
        db = create(side, "jm", driver="mem", pack_size=256,
                    background_merge=False)
        accts, txns = db.create_table(Account), db.create_table(Txn)
        accts.insert([Account(name_code=i * 11) for i in range(20)])
        txns.insert({"id": np.zeros(300, np.uint64), "acct": aid,
                     "amount": amt})
        txns.merge()
        accts.merge()
        mixed = multiset(knox.join(txns.query().where(knox.F("amount") > 0),
                                   accts.query(), on=("acct", "id")))
        FT = knox.FieldType
        tags = db.create_table(knox.Builder("tg").pk("id")
                               .add("name", FT.STRING)
                               .add("w", FT.INT32).finish())
        people = db.create_table(knox.Builder("pp").pk("id")
                                 .add("name", FT.STRING).finish())
        tags.insert({"id": np.zeros(60, np.uint64), "name": tag, "w": wv})
        people.insert({"id": np.zeros(3, np.uint64),
                       "name": ["boreas", "eos", "zeus"]})
        tags.merge()
        strings = multiset(knox.join(people.query(), tags.query(),
                                     on=("name", "name"), how="left",
                                     where=knox.F("w") >= 0))
        db.close()
        return mixed, strings
    mixed, strings = both(case)
    assert len(mixed) == int((amt > 0).sum())
    # rows: (id, name, r_id, r_name, w)
    want = sum(1 for n, v in zip(tag, wv) if n in ("boreas", "eos") and v >= 0)
    assert len(strings) == want and all(r[4][2] >= 0 for r in strings)
