"""knoxdb_tpu_torch.knox against knoxdb_tpu.knox: the same seeded SDK
calls (the cases of tests/test_knox.py, the enum, LLB and count-distinct
cases of test_enum_llb.py and the CSV cases of test_csv_fuse.py) give
equal answers in both packages: counts, python-int sums, scaled decimals,
typed rows, rows() / execute() / stream_batches() batch by batch,
describe(), LLB registers bit for bit. The port runs on the CPU."""

import dataclasses
import io
from dataclasses import dataclass

import numpy as np
import pytest

import knoxdb_tpu.utils.csvio as RCSV
import knoxdb_tpu_torch as KT
import knoxdb_tpu_torch.utils.csvio as TCSV
from knoxdb_tpu.filter.llb import LLB as RLLB
from knoxdb_tpu_torch.filter.llb import LLB as TLLB

from torch_engine_pair import same
from torch_knox_pair import both, create, open_db


@dataclass
class Account:
    id: int = 0
    balance: int = 0
    kind: int = 0


FILE = dict(driver="file", pack_size=256, journal_size=1 << 20,
            background_merge=False)


def _db(side, root, name="t", **kw):
    return create(side, name, path=str(root / side), **{**FILE, **kw})


def test_sdk_surface_is_lazy():
    import importlib
    import sys
    assert KT.knox is sys.modules["knoxdb_tpu_torch.knox"]
    assert KT.create_database is KT.knox.create_database
    assert KT.open_database is KT.knox.open_database
    assert {"OrderType", "JoinType", "create_database"} <= set(KT.__all__)
    mod = importlib.import_module("knoxdb_tpu_torch.knox")
    for name in ("Database", "TableHandle", "Query", "GroupQuery", "F",
                 "cond", "union", "join", "Builder", "field_meta",
                 "schema_of"):
        assert hasattr(mod, name), name


def test_cuda_database_without_a_card_raises(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        KT.create_database("nocard", driver="file", path=str(tmp_path))


# ---------------------------------------------------- tests/test_knox.py --

def test_insert_query_roundtrip(tmp_path):
    def case(side, knox):
        db = _db(side, tmp_path)
        acc = db.create_table(Account)
        rows = [Account(balance=i * 10, kind=i % 3) for i in range(1, 501)]
        pks = acc.insert(rows)
        q = acc.query().where(knox.F("balance") > 2500)
        got = acc.query().where(kind=1).limit(5).execute()
        out = {"pks": pks, "count": acc.count(), "q": q.count(),
               "sum": q.sum("balance"), "got": got}
        db.close()
        return out
    out = both(case)
    assert len(out["pks"]) == 500 and out["pks"][0] == 1
    assert out["count"] == 500
    assert out["q"] == sum(1 for i in range(1, 501) if i * 10 > 2500)
    assert out["sum"] == sum(i * 10 for i in range(1, 501) if i * 10 > 2500)
    assert len(out["got"]) == 5
    assert all(isinstance(g, Account) and g.kind == 1 for g in out["got"])


def test_merge_then_query(tmp_path):
    def case(side, knox):
        db = _db(side, tmp_path)
        acc = db.create_table(Account)
        acc.insert([Account(balance=i, kind=i % 5) for i in range(1, 2001)])
        acc.merge()
        out = {"journal_empty": acc._t.journal.is_empty(),
               "segments": len(acc._t.segments), "count": acc.count(),
               "range": acc.query().where(
                   knox.F("balance").between(100, 200)).count()}
        acc.insert([Account(balance=10**6)])
        out["mixed"] = acc.query().where(knox.F("balance") >= 10**6).count()
        out["count2"] = acc.count()
        out["aggs"] = acc.query().where(kind__in=[1, 3]).aggregate(
            ("count", ""), ("sum", "balance"), ("min", "balance"),
            ("max", "balance"), ("avg", "balance"))
        db.close()
        return out
    out = both(case)
    assert out["journal_empty"] and out["segments"] == 1
    assert (out["count"], out["range"], out["mixed"], out["count2"]) == \
        (2000, 101, 1, 2001)


def test_update_delete_visibility(tmp_path):
    def case(side, knox):
        db = _db(side, tmp_path)
        acc = db.create_table(Account)
        acc.insert([Account(balance=100), Account(balance=200),
                    Account(balance=300)])
        acc.merge()
        acc.update([Account(id=2, balance=999)])
        out = {"upd": acc.query().where(id=2).execute()[0].balance,
               "c3": acc.count(),
               "deleted": acc.delete(acc.query().where(id=1)),
               "c2": acc.count(),
               "gone": acc.query().where(id=1).count()}
        acc.merge()
        out["after"] = (acc.count(),
                        sorted(r.balance for r in acc.query().execute()))
        db.close()
        return out
    out = both(case)
    assert out == {"upd": 999, "c3": 3, "deleted": 1, "c2": 2, "gone": 0,
                   "after": (2, [300, 999])}


def test_get_point_lookup(tmp_path):
    def case(side, knox):
        db = _db(side, tmp_path)
        acc = db.create_table(Account)
        acc.insert([Account(balance=5), Account(balance=6)])
        out = (acc.get(2), acc.get(999))
        db.close()
        return out
    got, missing = both(case)
    assert got.balance == 6 and missing is None


def test_tx_abort(tmp_path):
    def case(side, knox):
        db = _db(side, tmp_path)
        acc = db.create_table(Account)
        acc.insert([Account(balance=1)])
        tx = db.begin()
        acc.insert([Account(balance=2)], tx=tx)
        tx.abort()
        out = acc.count()
        db.close()
        return out
    assert both(case) == 1


def test_tx_isolation_snapshot(tmp_path):
    def case(side, knox):
        db = _db(side, tmp_path)
        acc = db.create_table(Account)
        acc.insert([Account(balance=1)])
        tx = db.begin()
        acc.insert([Account(balance=2)], tx=tx)
        before = acc.count()
        tx.commit()
        out = (before, acc.count())
        db.close()
        return out
    assert both(case) == (1, 2)


def test_persistence_recovery(tmp_path):
    def case(side, knox):
        d1 = create(side, "t", driver="file", path=str(tmp_path / side),
                    pack_size=256, background_merge=False)
        acc = d1.create_table(Account)
        acc.insert([Account(balance=i) for i in range(1, 101)])
        acc.merge()
        acc.insert([Account(balance=777)])
        d1.close()
        d2 = open_db(side, "t", driver="file", path=str(tmp_path / side),
                     background_merge=False)
        acc2 = d2.table("account", Account)
        out = (acc2.count(),
               acc2.query().where(knox.F("balance") == 777).count(),
               acc2.insert([Account(balance=1234)]))
        d2.close()
        return out
    count, n777, pks = both(case)
    assert count == 101 and n777 == 1 and pks[0] == 102


def test_wide_decimal_column(tmp_path):
    def case(side, knox):
        db = _db(side, tmp_path)
        sch = (knox.Builder("d").pk("id")
               .add("amount", knox.FieldType.DECIMAL128, scale=6).finish())
        t = db.create_table(sch)
        vals = [123456789 * 10**6 + i for i in range(50)]
        t.insert({"id": np.zeros(50, np.uint64), "amount": vals})
        out = (t.count(),
               t.query().where(knox.cond("amount", "ge", vals[40])).count(),
               t.query().sum("amount"),
               t.query().where(id__le=3).rows())
        db.close()
        return out
    count, ge, s, rows = both(case)
    vals = [123456789 * 10**6 + i for i in range(50)]
    assert count == 50 and ge == 10 and s == sum(vals) / 10**6
    assert list(rows["amount"]) == [v / 10**6 for v in vals[:3]]


def test_delay_sync_mode(tmp_path):
    def case(side, knox):
        path = str(tmp_path / side / "dl")
        d = create(side, "dl", driver="file", path=path, wal_sync="delay",
                   background_merge=False)
        acc = d.create_table(Account)
        acc.insert([Account(balance=i) for i in range(50)])
        out = [acc.count()]
        d.close()
        d2 = open_db(side, "dl", driver="file", path=path,
                     background_merge=False)
        out.append(d2.table("account").count())
        d2.close()
        return out
    assert both(case) == [50, 50]


def test_device_cache_eviction(tmp_path):
    def case(side, knox):
        d = create(side, "cv", driver="mem", pack_size=256,
                   background_merge=False, device_cache_bytes=1)
        acc = d.create_table(Account)
        acc._t.MIN_MERGE_TAIL = 0
        for r in range(4):
            acc.insert([Account(balance=r * 1000 + i) for i in range(300)])
            acc.merge()
        out = {"segments": len(acc._t.segments), "count": acc.count(),
               "q": [acc.query().where(knox.F("balance") >= 0).count()
                     for _ in range(3)]}
        out["evicted"] = d.engine.cache.evictions > 0
        out["lt"] = acc.query().where(knox.F("balance") < 1000).count()
        d.close()
        return out
    out = both(case)
    assert out["segments"] >= 2 and out["count"] == 1200
    assert out["q"] == [1200] * 3 and out["evicted"] and out["lt"] == 300


def test_stream_batches_incremental(tmp_path, rng):
    n = 5000
    k = rng.integers(0, 100, n)
    v = rng.integers(-10**6, 10**6, n)

    @dataclass
    class S:
        id: int = 0
        k: int = 0
        v: int = 0

    def case(side, knox):
        db = create(side, "stream", driver="mem", pack_size=256,
                    background_merge=False)
        t = db.create_table(S)
        t.insert({"id": np.zeros(n, np.uint64), "k": k, "v": v})
        t.merge()
        t.insert([S(k=50, v=777)])

        def q():
            return db.table("s").query().where(k__ge=50).select("k", "v")
        seen = []
        out = {"rows": q().rows(),
               "batches": list(q().stream_batches(batch_packs=4)),
               "cnt": q().limit(10).stream(seen.append), "seen": seen,
               "all": q().execute()}
        db.close()
        return out
    out = both(case)
    batches = out["batches"]
    assert len(batches) > 1
    got_k = np.concatenate([b["k"] for b in batches])
    assert sorted(got_k.tolist()) == sorted(np.asarray(out["rows"]["k"])
                                            .tolist())
    for b in batches[:-1]:
        assert len(b["k"]) <= 4 * 256
    assert out["cnt"] == 10 and len(out["seen"]) == 10


def test_import_union_describe(tmp_path):
    @dataclass
    class U:
        id: int = 0
        k: int = 0
        v: int = 0

    n = 700
    lines = ["v,junk,k,id"] + [f"{i * 3},x,{i % 5},0" for i in range(n)]

    def case(side, knox):
        db = create(side, "ops", driver="mem", pack_size=256,
                    background_merge=False)
        ta = db.create_table(U)
        out = {"imported": ta.import_csv(io.StringIO("\n".join(lines)),
                                         batch_rows=100),
               "count": ta.count(), "sum": ta.query().sum("v")}
        ta.merge()
        q1 = ta.query().where(k=1).select("k", "v")
        q2 = ta.query().where(k=2).select("k", "v")
        out["union"] = list(knox.union(q1, q2, batch_packs=1))
        out["describe"] = db.describe("u")
        db.close()
        return out
    out = both(case)
    assert out["imported"] == n and out["count"] == n
    assert out["sum"] == sum(i * 3 for i in range(n))
    ks = [int(x) for b in out["union"] for x in b["k"]]
    n1 = sum(1 for i in range(n) if i % 5 == 1)
    assert ks[:n1] == [1] * n1 and set(ks[n1:]) == {2}
    d = out["describe"]
    assert d["rows"] == n and d["segments"] == 1 and d["fields"][0]["pk"]


def test_truncate_table(tmp_path, rng):
    @dataclass
    class TR:
        id: int = 0
        k: int = 0

    ks = rng.integers(0, 50, 500)

    def case(side, knox):
        db = _db(side, tmp_path, "trunc")
        t = db.create_table(TR)
        t.create_index(["k"], kind="int")
        t.insert({"id": np.zeros(500, np.uint64), "k": ks})
        t.merge()
        t.insert([TR(k=7)])
        out = [t.count()]
        t.truncate()
        out += [t.count(), t.query().where(k__ge=0).count()]
        t.insert([TR(k=1)])
        out.append(t.query().where(k=1).count())
        db.close()
        db2 = open_db(side, "trunc", driver="file",
                      path=str(tmp_path / side), background_merge=False)
        out.append(db2.table("tr").count())
        db2.close()
        return out
    assert both(case) == [501, 0, 0, 1, 1]


def test_filter_mode_aliases(tmp_path):
    def case(side, knox):
        from importlib import import_module
        types = import_module(knox.__name__.rsplit(".", 1)[0] + ".types")
        FM, parse = types.FilterMode, types.parse_filter_mode
        assert parse("range") == FM.RANGE and parse("rg") == FM.RANGE
        assert parse("nin") == FM.NOT_IN and parse("NIN") == FM.NOT_IN
        with pytest.raises(ValueError, match="unknown filter mode"):
            parse("between")
        db = _db(side, tmp_path)
        t = db.create_table(Account)
        t.insert([Account(balance=i, kind=0) for i in range(100)])
        t.merge()
        out = t.query().where(knox.cond("balance", "range", (10, 20))).count()
        db.close()
        return out
    assert both(case) == 11


# ------------------------------------------------ tests/test_enum_llb.py --

def _order2(side):
    """Order2 of test_enum_llb.py with each package's field_meta."""
    from torch_knox_pair import SDK
    return dataclasses.make_dataclass("Order2", [
        ("id", int, dataclasses.field(default=0)),
        ("status", str, dataclasses.field(
            default="", metadata=SDK[side].field_meta(enum="status"))),
        ("amount", int, dataclasses.field(default=0))])


def test_enum_roundtrip():
    def case(side, knox):
        db = create(side, "e", driver="mem", pack_size=256,
                    background_merge=False)
        db.create_enum("status", ["new", "paid", "shipped", "void"])
        O2 = _order2(side)
        t = db.create_table(O2)
        t.insert([O2(status="new", amount=5), O2(status="paid", amount=10),
                  O2(status="paid", amount=20)])
        out = {"eq": t.query().where(knox.cond("status", "eq", "paid"))
               .count(),
               "in": t.query().where(knox.cond("status", "in",
                                               ["new", "void"])).count(),
               "rows": t.query().select("status", "amount").rows(),
               "batches": list(t.query().select("status")
                               .stream_batches())}
        with pytest.raises(KeyError):
            t.insert([O2(status="bogus")])
        db.close()
        return out
    out = both(case)
    assert out["eq"] == 2 and out["in"] == 1
    assert list(out["rows"]["status"]) == ["new", "paid", "paid"]


def test_enum_persistence(tmp_path):
    def case(side, knox):
        path = str(tmp_path / side)
        d = create(side, "e", driver="file", path=path,
                   background_merge=False)
        d.create_enum("status", ["a", "b"])
        O2 = _order2(side)
        d.create_table(O2).insert([O2(status="b")])
        d.close()
        d2 = open_db(side, "e", driver="file", path=path,
                     background_merge=False)
        out = d2.table("order2").query().where(
            knox.cond("status", "eq", "b")).count()
        d2.close()
        return out
    assert both(case) == 1


@pytest.mark.parametrize("true_card", [100, 5000, 200000])
def test_llb_registers_bit_for_bit(rng, true_card):
    keys = rng.integers(0, true_card, true_card * 3, dtype=np.uint64)
    r, t = RLLB(), TLLB()
    r.add_keys64(keys)
    t.add_keys64(keys)
    np.testing.assert_array_equal(t.reg, r.reg)
    assert t.reg.dtype == r.reg.dtype
    same(t.cardinality(), r.cardinality())
    actual = len(np.unique(keys))
    assert abs(t.cardinality() - actual) / actual < 0.05


def test_llb_merge(rng):
    a = rng.integers(0, 10000, 20000, dtype=np.uint64)
    b = rng.integers(5000, 15000, 20000, dtype=np.uint64)
    sk = {}
    for side, L in (("ref", RLLB), ("port", TLLB)):
        s1, s2 = L(), L()
        s1.add_keys64(a)
        s2.add_keys64(b)
        sk[side] = s1.merge(s2)
    np.testing.assert_array_equal(sk["port"].reg, sk["ref"].reg)
    same(sk["port"].cardinality(), sk["ref"].cardinality())


def test_count_distinct(rng):
    v = rng.integers(0, 200, 3000).astype(np.uint32)
    w = rng.integers(-50, 50, 3000)

    def case(side, knox):
        db = create(side, "cd", driver="mem", pack_size=256,
                    background_merge=False)
        sch = (knox.Builder("t").pk("id").add("v", knox.FieldType.UINT32)
               .add("w", knox.FieldType.INT64).finish())
        t = db.create_table(sch)
        t.insert({"id": np.zeros(3000, np.uint64), "v": v, "w": w})
        t.merge()
        q = t.query().where(knox.F("w") > 0)
        out = (t.query().count_distinct("v"),
               t.query().count_distinct("v", exact=False),
               q.count_distinct("v"),
               t.query().where(knox.F("w") > 0).count_distinct("w",
                                                              exact=False))
        db.close()
        return out
    exact, approx, fexact, fapprox = both(case)
    assert exact == len(np.unique(v))
    assert abs(approx - exact) <= 10
    assert fexact == len(np.unique(v[w > 0]))
    assert abs(fapprox - len(np.unique(w[w > 0]))) <= 2


def test_query_stats(rng):
    vals = rng.integers(0, 100, 1000).astype(np.uint32)

    def case(side, knox):
        db = create(side, "qs", driver="mem", pack_size=256,
                    background_merge=False)
        sch = knox.Builder("t").pk("id").add("v", knox.FieldType.UINT32) \
            .finish()
        t = db.create_table(sch)
        t.insert({"id": np.zeros(1000, np.uint64), "v": vals})
        t.merge()
        with db.begin(read_only=True) as tx:
            res = t._t.query(tx.snapshot, None)
        assert res.stats["total_time"] > 0
        out = (sorted(res.stats), res.stats["packs_scanned"])
        db.close()
        return out
    keys, scanned = both(case)
    assert scanned > 0 and {"scan_time", "journal_time"} <= set(keys)


# ------------------------------------------ CSV cases of test_csv_fuse.py --

def test_csv_roundtrip(rng):
    n = 50
    data = {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "v": rng.integers(-10**9, 10**9, n),
        "f": rng.normal(size=n),
        "s": [f"name,{i};x" for i in range(n)],
        "b": [bytes([i, 255 - i]) for i in range(n)],
        "d": [int(x) for x in rng.integers(-10**6, 10**6, n)],
    }

    def case(side, knox):
        sch = (knox.Builder("t").pk("id")
               .add("v", knox.FieldType.INT64)
               .add("f", knox.FieldType.FLOAT64)
               .add("s", knox.FieldType.STRING)
               .add("b", knox.FieldType.BYTES)
               .add("d", knox.FieldType.DECIMAL64, scale=2).finish())
        CS = RCSV if side == "ref" else TCSV
        text = CS.write_csv(sch, data, n)
        return text, CS.read_csv(sch, text)
    text, back = both(case)
    np.testing.assert_array_equal(back["v"], data["v"])
    assert list(back["b"]) == data["b"] and back["d"] == data["d"]


def test_csv_sniffer():
    for sample in ("a;b;c\n1;2;3\n4;5;6\n", "a|b\n1|2\n", "a\tb\n1\t2\n",
                   "a,b\n1,2\n"):
        r, t = RCSV.sniff_dialect(sample), TCSV.sniff_dialect(sample)
        assert t.delimiter == r.delimiter
    assert TCSV.sniff_dialect("a;b;c\n1;2;3\n4;5;6\n").delimiter == ";"


def test_csv_decimal_exact(tmp_path):
    text = "id,d\n1,0.1\n2,-12.3456\n3,7\n4,+.5\n5,-0.00009\n"

    def case(side, knox):
        sch = knox.Builder("t").pk("id").add(
            "d", knox.FieldType.DECIMAL64, scale=4).finish()
        CS = RCSV if side == "ref" else TCSV
        back = CS.read_csv(sch, text)
        db = create(side, "dec", driver="mem", pack_size=256,
                    background_merge=False)
        t = db.create_table(sch)
        got = (back["d"], t.import_csv(io.StringIO(text.replace(",", ";"))),
               t.query().sum("d"), t.query().select("d").rows())
        db.close()
        return got
    parsed, n, s, rows = both(case)
    assert parsed == [1000, -123456, 70000, 5000, 0] and n == 5
    assert list(rows["d"]) == [0.1, -12.3456, 7.0, 0.5, 0.0]
