"""knoxdb_tpu_torch's Engine and Table against knoxdb_tpu's: the same
seeded inserts, updates, deletes, merges (incremental and rewriting),
reopens from WAL and store, indexes, enums and history tables give equal
counts, aggregates, groups, ordered rows, streams and join pairs, and the
same files on disk (mirrors tests/test_incremental_merge.py,
test_history.py, test_index.py, the enum half of test_enum_llb.py,
test_advice_fixes.py and test_depth_r2.py, driven through Engine and
Table). The port's engine runs on the CPU here."""

import dataclasses

import numpy as np
import pytest

import knoxdb_tpu.types as RT
import knoxdb_tpu_torch.schema.schema as TSCH
import knoxdb_tpu_torch.types as TT
from knoxdb_tpu_torch.encode.schemes import Scheme
from knoxdb_tpu_torch.engine.engine import Engine, Options
from knoxdb_tpu_torch.engine.table import Table

from torch_engine_pair import PKG, SIDES, Pair, leaf, same

ROW = [("v", "INT64"), ("tag", "INT64")]


@pytest.fixture(autouse=True)
def _zlib(monkeypatch):
    # segment blobs compare byte for byte under a named codec
    monkeypatch.setenv("KNOX_SEG_COMPRESS", "zlib")


def _fill(p, n, start=0):
    v = np.arange(start, start + n, dtype=np.int64)
    p.insert({"id": np.zeros(n, np.uint64), "v": v, "tag": v % 97})
    p.merge()


# ----------------------------------------------------- incremental merge --

def test_scattered_delete_is_incremental(tmp_path):
    p = Pair(tmp_path, "inc", ROW)
    _fill(p, 3000)
    seg0 = p.tab["port"].segments[0].seg
    dels = [5, 777, 1500, 2998]
    assert p.delete(leaf("v", "IN", dels)) == 4
    p.merge()
    assert p.tab["port"].segments[0].seg is seg0
    assert p.segments() == [(3000, 4)]
    assert p.count() == 2996
    assert p.count(leaf("v", "IN", dels)) == 0
    got = p.query(leaf("v", "LT", 10), project=["v"])
    assert got.rows["v"].tolist() == [0, 1, 2, 3, 4, 6, 7, 8, 9]
    r = p.query(None, [("count",), ("sum", "v"), ("min", "v"), ("max", "v"),
                       ("avg", "v")])
    assert r.aggs[("sum", "v")] == sum(range(3000)) - sum(dels)
    p.same_files()
    p.close()


def test_dead_fraction_triggers_rewrite(tmp_path):
    p = Pair(tmp_path, "rw", ROW)
    _fill(p, 3000)
    seg0 = p.tab["port"].segments[0].seg
    assert p.delete(leaf("v", "LT", 600)) == 600
    p.merge()
    assert p.tab["port"].segments[0].seg is not seg0
    assert p.segments() == [(2400, 0)]
    assert p.count() == 2400
    p.same_files()
    p.close()


def test_dead_bitmap_survives_reopen(tmp_path):
    p = Pair(tmp_path, "reo", ROW)
    _fill(p, 3000)
    p.delete(leaf("v", "IN", [10, 20, 30]))
    p.merge()
    # a committed batch left in the journal, replayed from the WAL
    p.insert({"id": np.zeros(40, np.uint64),
              "v": np.arange(5000, 5040, dtype=np.int64),
              "tag": np.full(40, 3, np.int64)})
    p.same_files()
    p.reopen()
    assert p.segments() == [(3000, 3)]
    assert p.count() == 3037
    assert p.count(leaf("v", "IN", [10, 20, 30])) == 0
    r = p.query(None, [("sum", "v")])
    assert r.aggs[("sum", "v")] == sum(range(3000)) - 60 \
        + sum(range(5000, 5040))
    p.same_files()
    p.close()


def test_segment_count_bounded(tmp_path):
    p = Pair(tmp_path, "bnd", ROW)
    for i in range(14):
        _fill(p, 1100, start=i * 1100)
    assert len(p.tab["port"].segments) <= Table.MAX_SEGMENTS
    p.segments()
    r = p.query(None, [("count",), ("sum", "v")])
    assert r.count == 14 * 1100 and r.aggs[("sum", "v")] \
        == sum(range(14 * 1100))
    p.same_files()
    p.close()


def test_index_incremental_consistency(tmp_path):
    p = Pair(tmp_path, "ixi", ROW)
    _fill(p, 3000)
    idx = {s: p.tab[s].create_index(
        ["tag"], kind=(RT if s == "ref" else TT).IndexType.INT)
        for s in SIDES}
    assert len(idx["port"].rids) == 3000
    p.delete(leaf("v", "IN", [7, 104, 201]))
    p.insert({"id": np.zeros(50, np.uint64),
              "v": np.arange(9000, 9050, dtype=np.int64),
              "tag": np.full(50, 7, np.int64)})
    p.merge()
    oracle = len([v for v in range(3000)
                  if v % 97 == 7 and v not in (7, 104, 201)]) + 50
    assert p.count(leaf("tag", "EQ", 7)) == oracle
    same(idx["ref"].rids, idx["port"].rids)
    same(idx["ref"].keys, idx["port"].keys)
    assert len(idx["port"].rids) == 3000 - 3 + 50
    p.delete(leaf("v", "EQ", 9001))
    p.merge()
    assert p.count(leaf("tag", "EQ", 7)) == oracle - 1
    p.close()


# -------------------------------------------------------------- history --

def test_history_on_update_and_delete(tmp_path):
    p = Pair(tmp_path, "h", [("balance", "INT64")], table="acct",
             history=True)
    p.insert({"id": np.zeros(3, np.uint64),
              "balance": np.array([100, 200, 300], np.int64)})
    p.merge()
    p.update({"id": np.array([2], np.uint64),
              "balance": np.array([250], np.int64)})
    p.update({"id": np.array([2], np.uint64),
              "balance": np.array([299], np.int64)})
    assert p.delete(leaf("id", "EQ", 1)) == 1

    def hist(s, e, t):
        h = e.history_table_for(t)
        with e.begin(read_only=True) as tx:
            r = h.query(tx.snapshot, None, project=["id", "balance",
                                                    "$del_xid"])
        return r.rows
    rows = p._both(hist)
    got = sorted((int(i), int(b)) for i, b in zip(rows["id"],
                                                  rows["balance"]))
    assert got == [(1, 100), (2, 200), (2, 250)]
    assert p.count() == 2
    assert p.query(leaf("id", "EQ", 2), project=["balance"]) \
        .rows["balance"].tolist() == [299]
    p.merge()
    for s in SIDES:
        p.eng[s].history_table_for(p.tab[s]).merge()
    p.reopen()
    assert p.tab["port"].history_enabled
    assert p._both(lambda s, e, t: e.table("acct_history").query(
        e.begin(read_only=True).snapshot, None).count) == 3
    p.update({"id": np.array([3], np.uint64),
              "balance": np.array([301], np.int64)})
    assert p._both(lambda s, e, t: e.table("acct_history").query(
        e.begin(read_only=True).snapshot, None).count) == 4
    p.same_files()
    p.close()


# -------------------------------------------------------------- indexes --

EV = [("user", "INT64"), ("kind", "INT64"), ("v", "INT64")]


def test_index_eq_in_range(tmp_path, rng):
    p = Pair(tmp_path, "ix", EV, driver="mem")
    n = 3000
    user = rng.integers(1, 500, n)
    kind = rng.integers(0, 5, n)
    v = rng.integers(-100, 100, n)
    p.insert({"id": np.zeros(n, np.uint64), "user": user, "kind": kind,
              "v": v})
    p.merge()
    for s in SIDES:
        p.tab[s].create_index("user", (RT if s == "ref" else TT)
                              .IndexType.INT)
    assert p.count(leaf("user", "EQ", 7)) == int((user == 7).sum())
    assert p.count(leaf("user", "IN", [3, 9, 400])) \
        == int(np.isin(user, [3, 9, 400]).sum())
    spec = ("and", leaf("user", "RANGE", (10, 20)), leaf("v", "GT", 0))
    r = p.query(spec, [("count",), ("sum", "v")], project=["user", "v"])
    m = (user >= 10) & (user <= 20) & (v > 0)
    assert r.count == int(m.sum())
    assert r.aggs[("sum", "v")] == int(v[m].sum())
    p.close()


def test_index_stays_correct_after_updates(tmp_path):
    p = Pair(tmp_path, "ixu", EV, driver="mem")
    p.insert({"id": np.zeros(3, np.uint64),
              "user": np.array([1, 2, 2]), "kind": np.zeros(3, np.int64),
              "v": np.array([10, 20, 30])})
    p.merge()
    for s in SIDES:
        p.tab[s].create_index("user", (RT if s == "ref" else TT)
                              .IndexType.HASH)
    assert p.count(leaf("user", "EQ", 2)) == 2
    p.insert({"id": np.zeros(1, np.uint64), "user": np.array([2]),
              "kind": np.zeros(1, np.int64), "v": np.array([40])})
    assert p.count(leaf("user", "EQ", 2)) == 3
    assert p.delete(leaf("v", "EQ", 20)) == 1
    assert p.count(leaf("user", "EQ", 2)) == 2
    p.merge()
    assert p.count(leaf("user", "EQ", 2)) == 2
    p.close()


def test_composite_index_lookup(tmp_path, rng):
    p = Pair(tmp_path, "ixc", EV, driver="mem")
    n = 500
    user = rng.integers(1, 10, n)
    kind = rng.integers(0, 3, n)
    p.insert({"id": np.zeros(n, np.uint64), "user": user, "kind": kind,
              "v": np.zeros(n, np.int64)})
    p.merge()

    def look(s, e, t):
        idx = t.create_index(["user", "kind"], (RT if s == "ref" else TT)
                             .IndexType.COMPOSITE)
        from knoxdb_tpu_torch.exec import oracle as ORC
        ku = int(ORC.column_keys(np.array([4]), t.schema.field("user")
                                 .type)[0])
        kk = int(ORC.column_keys(np.array([1]), t.schema.field("kind")
                                 .type)[0])
        return idx.lookup_eq((ku, kk)).to_array()
    rids = p._both(look)
    assert len(rids) == int(((user == 4) & (kind == 1)).sum())
    p.close()


# ---------------------------------------------------------------- enums --

def _order_schema(SCH):
    cls = dataclasses.make_dataclass("Order2", [
        ("id", int, dataclasses.field(default=0)),
        ("status", str, dataclasses.field(
            default="", metadata=SCH.field_meta(enum="status"))),
        ("amount", int, dataclasses.field(default=0))])
    return SCH.schema_of(cls)


def test_enum_roundtrip_and_persistence(tmp_path):
    """Enum columns store dictionary codes; the registry persists in the
    catalog and codes survive a reopen."""
    out = {}
    for side in SIDES:
        E, _S, Q, SCH, T = PKG[side]
        kw = dict(driver="file", path=str(tmp_path / side), pack_size=256,
                  background_merge=False)
        if side == "port":
            kw["device"] = "cpu"
        e = E.Engine("en", E.Options(**kw))
        en = e.enums.create("status", ["new", "paid", "shipped", "void"])
        sch = _order_schema(SCH)
        assert sch.field("status").is_enum
        t = e.create_table(sch)
        codes = np.array([en.code(s) for s in
                          ("new", "paid", "paid", "void")], np.uint16)
        with e.begin() as tx:
            t.insert_rows(tx, {"id": np.zeros(4, np.uint64),
                               "status": codes,
                               "amount": np.array([5, 10, 20, 1])})
        t.merge()
        e.enums.extend("status", ["refunded"])
        e._save_catalog()
        e.close()
        e = E.Engine("en", E.Options(**kw))
        t = e.table("order2")
        en = e.enums.get("status")
        counts = []
        with e.begin(read_only=True) as tx:
            for mode, val in (("EQ", en.code("paid")),
                              ("IN", [en.code("new"), en.code("void")])):
                counts.append(t.query(tx.snapshot, Q.leaf(Q.Filter(
                    t.schema.field("status"), T.FilterMode[mode],
                    val)).optimize()).count)
        out[side] = (counts, en.code("refunded"), en.value(2),
                     e.enums.to_dict(), t.schema.to_dict())
        e.close()
    assert out["ref"] == out["port"]
    assert out["port"][:3] == ([2, 2], 4, "shipped")


# ------------------------------------------------- floats, ALP, sorting --

PX = [("x", "FLOAT64"), ("v", "INT64")]


def test_alp_merged_strict_range(tmp_path):
    p = Pair(tmp_path, "alp", PX, pack_size=1024)
    n = 3000
    xs = (np.arange(n) % 1000) / 100.0
    p.insert({"id": np.zeros(n, np.uint64), "x": xs, "v": np.arange(n)})
    p.merge()
    assert Scheme.ALP in {pk.scheme for h in p.tab["port"].segments
                          for pk in h.seg.columns["x"].packs}
    xs2 = (np.arange(n) % 900) / 100.0
    p.insert({"id": np.zeros(n, np.uint64), "x": xs2, "v": np.arange(n)})
    allx = np.concatenate([xs, xs2])
    for lo_mode, lo, hi_mode, hi, want in (
            ("GT", 5.0, "LE", 9.5, (allx > 5.0) & (allx <= 9.5)),
            ("GE", 2.0, "LT", 5.0, (allx >= 2.0) & (allx < 5.0)),
            ("GT", 5.0, "GT", 3.0, allx > 5.0)):
        spec = ("and", leaf("x", lo_mode, lo), leaf("x", hi_mode, hi))
        r = p.query(spec, [("count",), ("sum", "x"), ("min", "x")])
        assert r.count == int(want.sum())
    p.close()


def test_float_containers_via_keyform(tmp_path, rng):
    """Low-cardinality full-mantissa floats dict-encode, runs RLE-encode,
    and specials (-0.0, +-inf, NaN) keep the keyform total order."""
    p = Pair(tmp_path, "fl", [("x", "FLOAT64"), ("y", "FLOAT64")])
    uniq = rng.standard_normal(9)
    x = rng.choice(uniq, 1500)
    y = np.repeat(rng.standard_normal(6), 250)
    p.insert({"id": np.zeros(1500, np.uint64), "x": x, "y": y})
    p.merge()
    schemes = {pk.scheme for pk in
               p.tab["port"].segments[0].seg.columns["x"].packs}
    assert schemes == {Scheme.DICT}
    sp = np.array([-np.inf, -1.5, -0.0, 0.0, 2.5, np.inf, np.nan] * 10)
    p.insert({"id": np.zeros(len(sp), np.uint64), "x": sp, "y": sp})
    thr = float(np.median(uniq))
    for spec in (leaf("x", "GT", thr), leaf("y", "LE", 0.0),
                 leaf("x", "EQ", float(uniq[3]))):
        p.query(spec, [("count",), ("sum", "x"), ("max", "y")])
    p.sorted(None, "x", limit=20, project=["id", "x"])
    p.sorted(None, "y", desc=True, project=["id", "y"])
    p.close()


def test_sorted_query_across_segments_and_deletes(tmp_path, rng):
    p = Pair(tmp_path, "srt", ROW)
    for _ in range(3):
        n = 1100
        p.insert({"id": np.zeros(n, np.uint64),
                  "v": rng.integers(-5000, 5000, n),
                  "tag": rng.integers(0, 7, n)})
        p.merge()
    assert len(p.tab["port"].segments) == 3
    p.insert({"id": np.zeros(40, np.uint64),
              "v": rng.integers(-5000, 5000, 40), "tag": np.full(40, 3)})
    # the smallest values die in the journal while their rows stay sealed
    low = p.sorted(None, "v", limit=50, project=["id"]).rows["id"]
    p.delete(leaf("id", "IN", [int(x) for x in low]))
    for desc, lim in ((False, 17), (True, 500)):
        p.sorted(None, "v", desc=desc, limit=lim, project=["v", "id"])
    p.sorted(leaf("tag", "EQ", 3), "v", limit=100, project=["v"])
    p.close()


# ------------------------------------------------------ durability, WAL --

def test_manifest_ignores_staged_blobs(tmp_path):
    p = Pair(tmp_path, "mf", ROW)
    _fill(p, 300)
    for s in SIDES:
        b = p.eng[s].store.bucket(f"table_{p.tab[s].id}_segments")
        b.put(b"ffffffff_9999", b"GARBAGE-NOT-A-SEGMENT")
    p.reopen()
    assert p.count() == 300
    _fill(p, 10, start=300)
    for s in SIDES:
        keys = set(p.eng[s].store.bucket(
            f"table_{p.tab[s].id}_segments").keys())
        assert b"ffffffff_9999" not in keys
    assert p.count() == 310
    p.same_files()
    p.close()


def test_torn_wal_tail_recovers(tmp_path):
    p = Pair(tmp_path, "torn", ROW)
    p.insert({"id": np.zeros(100, np.uint64), "v": np.arange(100),
              "tag": np.zeros(100, np.int64)})
    p.close()
    for s in SIDES:
        seg = sorted((tmp_path / s).glob("**/wal_*.seg"))[-1]
        with open(seg, "ab") as fh:
            fh.write(b"\x01\x00\xde\xad\xbe")
    p._open()
    p.tab = {s: p.eng[s].table("t") for s in SIDES}
    assert p.count() == 100
    p.insert({"id": np.zeros(1, np.uint64), "v": np.array([777]),
              "tag": np.zeros(1, np.int64)})
    assert p.count() == 101
    p.same_files()
    p.close()


def test_reopen_after_checksum_damage_before_checkpoint(tmp_path):
    p = Pair(tmp_path, "ck", ROW)
    _fill(p, 300)
    p.insert({"id": np.zeros(1, np.uint64), "v": np.array([12345]),
              "tag": np.ones(1, np.int64)})
    p.close()
    for s in SIDES:
        seg = sorted((tmp_path / s / "wal").glob("*.seg"))[0]
        raw = bytearray(seg.read_bytes())
        raw[40:44] = b"\x99\x99\x99\x99"
        seg.write_bytes(bytes(raw))
    p._open()
    p.tab = {s: p.eng[s].table("t") for s in SIDES}
    assert p.count() == 301
    assert p.count(leaf("v", "EQ", 12345)) == 1
    p.close()


def test_truncate_and_drop(tmp_path):
    p = Pair(tmp_path, "tr", ROW)
    _fill(p, 600)
    p.insert({"id": np.zeros(5, np.uint64), "v": np.arange(5),
              "tag": np.zeros(5, np.int64)})
    for s in SIDES:
        p.eng[s].truncate_table("t")
    assert p.count() == 0
    _fill(p, 20, start=1000)
    assert p.count() == 20
    p.reopen()
    assert p.count() == 20
    p.same_files()
    for s in SIDES:
        p.eng[s].drop_table("t")
        assert "t" not in p.eng[s].tables
    p.close()


def test_in_filter_accepts_set_and_tuple(tmp_path):
    p = Pair(tmp_path, "inset", ROW, driver="mem")
    p.insert({"id": np.zeros(10, np.uint64), "v": np.arange(10),
              "tag": np.zeros(10, np.int64)})
    p.merge()
    assert p.count(leaf("v", "IN", {1, 3, 5})) == 3
    assert p.count(leaf("v", "IN", (2, 4))) == 2
    p.close()


def test_journal_mixed_dtype_chunks_stay_exact():
    from knoxdb_tpu_torch.pack.journal import Journal
    from knoxdb_tpu_torch.types import Snapshot
    sch = TSCH.Builder("j").pk("id").add("v", TT.FieldType.UINT64).finish()
    j = Journal(sch.with_meta())
    big = (1 << 63) + 5
    names = [f.name for f in j.schema.fields]
    j.insert(1, np.array([1], np.uint64),
             {n: np.array([big], np.uint64) for n in names})
    j.insert(2, np.array([2], np.uint64),
             {n: np.array([7], np.int64) for n in names})
    j.commit(1)
    j.commit(2)
    data, rids = j.visible_rows(Snapshot(xown=0, xmin=0, xmax=0,
                                         xact=frozenset()))
    assert int(data["v"][0]) == big and int(data["v"][1]) == 7


def test_pack_size_validated(tmp_path):
    e = Engine("ps", Options(driver="mem", device="cpu",
                             path=str(tmp_path)))
    sch = TSCH.Builder("r").pk("id").add("v", TT.FieldType.INT64).finish()
    for bad in (100, 16):
        with pytest.raises(ValueError):
            e.create_table(sch, pack_size=bad)
    e.close()


# --------------------------------------------------- the device cache --

def test_eviction_drops_scanner_and_rebuilds(tmp_path):
    """A budget below one segment evicts on every touch: the handle's
    scanner (with its plan and operand caches) is dropped, the next query
    builds a fresh one, and the answers stay the reference's."""
    p = Pair(tmp_path, "ev", ROW, device_cache_bytes=1)
    for i in range(3):
        _fill(p, 1100, start=i * 1100)
    spec = leaf("v", "RANGE", (100, 3000))
    aggs = [("count",), ("sum", "v"), ("max", "tag")]
    r1 = p.query(spec, aggs)
    # the last segment a query touches stays resident, every other one
    # was evicted when the next was touched
    h = p.tab["port"].segments[-1]
    assert all(x.scanner is None for x in p.tab["port"].segments[:-1])
    sc = h.scanner
    assert sc is not None and sc._fns
    same(p.query(spec, aggs), r1)
    assert p.eng["port"].cache.evictions >= 5
    fresh = h.scanner
    assert fresh is not sc and fresh.d is not sc.d
    assert fresh._fns is not sc._fns and fresh._acache is not sc._acache
    assert not set(map(id, fresh._fns.values())) \
        & set(map(id, sc._fns.values()))
    p.group(spec, "tag", [("count", ""), ("sum", "v")])
    p.close()


def test_cache_2q_scan_resistance():
    from knoxdb_tpu_torch.engine.engine import CacheManager

    class H:
        def __init__(self, nbytes):
            self.seg = type("S", (), {"nbytes": nbytes})()
            self.dseg = object()
            self.scanner = object()

    cm = CacheManager(budget_bytes=1000)

    def touch(h):
        if h.dseg is None:
            h.dseg = object()
            h.scanner = object()
        cm.note_use(h)

    hot = [H(100) for _ in range(6)]
    for _ in range(3):
        for h in hot:
            touch(h)
    cold = [H(100) for _ in range(50)]
    for h in cold:
        touch(h)
    assert all(h.dseg is not None for h in hot)
    assert cm.evictions >= 40
    h0 = cm.hits
    for h in hot:
        touch(h)
    assert cm.hits == h0 + len(hot)
