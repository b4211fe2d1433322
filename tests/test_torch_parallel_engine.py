"""knoxdb_tpu_torch's engine and SDK on a mesh of eight CPU shards,
mirroring tests/test_spmd_engine.py and tests/test_multihost.py: a
mesh-attached database (shard-uniform segments, ShardedScanner scans,
knox.join down the shuffle branch) answers as the reference's
single-device database does (the reference's own tests hold its mesh
path equal to that), and as the port's own single-device database does.
Mesh-attached stores write the reference's mesh-attached segment blobs
byte for byte (its merge builds uniform=ndev on the host, so no query
runs on its mesh). A mesh across processes raises NotImplementedError."""

from dataclasses import dataclass

import numpy as np
import pytest
import torch

import knoxdb_tpu.knox as RK
import knoxdb_tpu_torch.knox as TK
from knoxdb_tpu_torch.parallel import (Mesh, ShardedScanner, attach,
                                       hybrid_mesh, initialize_from_env)
from knoxdb_tpu_torch.parallel import shuffle as TSH
from knoxdb_tpu_torch.testing.dryrun import dryrun_tables
from torch_engine_pair import Pair, same

NDEV = 8
CPU8 = Mesh([torch.device("cpu")] * NDEV, ("packs",))


@dataclass
class Row:
    id: int = 0
    val: int = 0          # uint-ish narrow
    bal: int = 0          # signed
    grp: int = 0          # small-cardinality group key
    px: float = 0.0       # ALP-encodable float


def _fill(t, n, rng):
    t.insert({
        "id": np.zeros(n, np.uint64),
        "val": rng.integers(0, 50_000, n),
        "bal": rng.integers(-1 << 40, 1 << 40, n),
        "grp": rng.integers(0, 20, n),
        "px": rng.integers(-10 ** 6, 10 ** 6, n) / 100.0,
    })


@pytest.fixture(scope="module")
def pair():
    """The reference's database on one device and the port's on CPU8."""
    r = RK.create_database("pe_r", driver="mem", pack_size=512,
                           background_merge=False)
    t = TK.create_database("pe_t", driver="mem", pack_size=512,
                           background_merge=False, device="cpu", mesh=CPU8)
    tabs = []
    for db in (r, t):
        tab = db.create_table(Row)
        _fill(tab, 20_000, np.random.default_rng(7))
        tab.merge()
        tabs.append(tab)
    yield tabs
    r.close()
    t.close()


def test_sharded_scanner_selected(pair):
    _r, t = pair
    h = t._t.segments[0]
    sc = h.scanner_()
    assert isinstance(sc, ShardedScanner) and len(sc.shards) == NDEV
    assert h.seg.npacks % NDEV == 0
    # the engine's image of the segment is metadata; the shards hold data
    assert not sc.d.with_arrays and h.dseg is sc.d


QUERIES = [
    lambda F, t: t.query().where(F("val") > 25_000),
    lambda F, t: t.query().where(F("val").between(100, 10_000), F("bal") > 0),
    lambda F, t: t.query().where(F("grp").in_([1, 5, 19])),
    lambda F, t: t.query().or_where(F("val") < 50, F("val") > 49_000),
    lambda F, t: t.query().where(F("px") > 5000.0, F("px") <= 9000.25),
    lambda F, t: t.query().where(F("bal") != 0),
]


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_count_filters_and_aggregates(pair, qi):
    r, t = pair
    q = QUERIES[qi]
    assert q(TK.F, t).count() == q(RK.F, r).count()
    if qi < 3:
        aggs = (("count", ""), ("sum", "bal"), ("min", "bal"),
                ("max", "val"))
        assert q(TK.F, t).aggregate(*aggs) == q(RK.F, r).aggregate(*aggs)


def test_float_sum_identical(pair):
    r, t = pair
    # ALP packs give exact rational sums on both paths
    assert t.query().where(TK.F("px") > 0.0).sum("px") == \
        r.query().where(RK.F("px") > 0.0).sum("px")


def test_group_by_identical(pair):
    r, t = pair
    aggs = (("count", ""), ("sum", "bal"), ("min", "bal"), ("max", "bal"))
    ga = r.query().where(RK.F("val") > 500).group_by("grp").aggregate(*aggs)
    gb = t.query().where(TK.F("val") > 500).group_by("grp").aggregate(*aggs)
    same(ga, gb)


def test_projection_rows_identical(pair):
    r, t = pair
    ra = r.query().where(RK.F("val") < 300).select("val", "bal").rows()
    rb = t.query().where(TK.F("val") < 300).select("val", "bal").rows()
    same(ra, rb)


def test_journal_and_deletes_identical(pair):
    r, t = pair
    extra = {
        "id": np.zeros(500, np.uint64),
        "val": np.arange(500) + 100_000,
        "bal": np.arange(500) - 250,
        "grp": np.arange(500) % 20,
        "px": np.arange(500) / 10.0,
    }
    r.insert(dict(extra))
    t.insert(dict(extra))
    r.delete(r.query().where(RK.F("val").between(100_100, 100_199)))
    t.delete(t.query().where(TK.F("val").between(100_100, 100_199)))
    assert t.count() == r.count()
    aggs = (("count", ""), ("sum", "bal"))
    assert t.query().where(TK.F("bal") < 0).aggregate(*aggs) == \
        r.query().where(RK.F("bal") < 0).aggregate(*aggs)
    r.merge()
    t.merge()
    assert t.count() == r.count()
    assert all(isinstance(h.scanner_(), ShardedScanner)
               for h in t._t.segments)


def test_wide_int128_and_strings_identical():
    @dataclass
    class SRow:
        id: int = 0
        name: str = ""

    rng = np.random.default_rng(3)
    vals = [int(v) * (10 ** 25 // 7) for v in rng.integers(-10 ** 6, 10 ** 6,
                                                          3000)]
    names = [f"acct-{i % 97:03d}" for i in range(5000)]
    out = {}
    for side, K, kw in (("r", RK, {}), ("t", TK, {"device": "cpu",
                                                  "mesh": CPU8})):
        FT = RK.FieldType if side == "r" else TK.FieldType
        db = K.create_database(f"wide_{side}", driver="mem", pack_size=256,
                               background_merge=False, **kw)
        from importlib import import_module
        B = import_module(K.__name__.rsplit(".", 1)[0]
                          + ".schema.schema").Builder
        w = db.create_table(B("wt").pk("id").add("amt", FT.INT128).finish())
        w.insert({"id": np.zeros(len(vals), np.uint64), "amt": vals})
        w.merge()
        s = db.create_table(SRow)
        s.insert({"id": np.zeros(len(names), np.uint64), "name": names})
        s.merge()
        q = w.query().where(K.F("amt") > 0)
        out[side] = (q.count(), q.sum("amt"), w.query().min("amt"),
                     w.query().max("amt"),
                     s.query().where(K.F("name") == "acct-042").count(),
                     s.query().where(K.F("name") >= "acct-090").count(),
                     s.query().where(K.F("name").in_(["acct-001",
                                                      "acct-096"])).count())
        db.close()
    assert out["r"] == out["t"]


# ------------------------------------------------------------ multihost --

def test_hybrid_mesh_shape(monkeypatch):
    monkeypatch.setenv("KNOX_VIRTUAL_HOSTS", "2")
    m = hybrid_mesh(devices=["cpu"] * 8)
    assert m.axis_names == ("hosts", "packs")
    assert m.shape["hosts"] == 2 and m.shape["packs"] == 4
    monkeypatch.delenv("KNOX_VIRTUAL_HOSTS")
    assert hybrid_mesh(devices=["cpu"] * 8).shape == {"hosts": 1,
                                                     "packs": 8}


def test_hybrid_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        hybrid_mesh()


def test_initialize_noop_without_env(monkeypatch):
    for v in ("KNOX_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
              "KNOX_NUM_PROCESSES"):
        monkeypatch.delenv(v, raising=False)
    assert initialize_from_env() is False


def test_initialize_from_env_world_size_one(monkeypatch):
    """The coordinator variables start a one-process gloo group on
    localhost; a second call finds it up."""
    import socket
    dist = torch.distributed
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("KNOX_COORDINATOR", f"localhost:{port}")
    monkeypatch.setenv("KNOX_NUM_PROCESSES", "1")
    monkeypatch.setenv("KNOX_PROCESS_ID", "0")
    try:
        assert initialize_from_env() is True
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        assert initialize_from_env() is True
        # world size 1: the in-process copies run
        assert CPU8.psum([1, 2, 3]) == 6
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_engine_query_on_hybrid_mesh(monkeypatch):
    monkeypatch.setenv("KNOX_VIRTUAL_HOSTS", "2")
    hybrid = hybrid_mesh(devices=["cpu"] * 8)
    r = RK.create_database("mh_r", driver="mem", pack_size=512,
                           background_merge=False)
    t = TK.create_database("mh_t", driver="mem", pack_size=512,
                           background_merge=False, device="cpu")
    flat = attach(t.engine, hybrid)
    assert flat.axis_names == ("packs",) and flat.shape["packs"] == 8
    assert t.engine.mesh is flat
    rng = np.random.default_rng(0xC0FFEE)
    n = 20_000
    data = {"id": np.zeros(n, np.uint64),
            "val": rng.integers(0, 50_000, n),
            "bal": rng.integers(-1 << 40, 1 << 40, n),
            "grp": np.zeros(n, np.int64), "px": np.zeros(n)}
    for db in (r, t):
        tab = db.create_table(Row)
        tab.insert({k: v.copy() for k, v in data.items()})
        tab.merge()
    for q in (lambda F, x: x.query().where(F("val") > 25_000).count(),
              lambda F, x: x.query().where(F("val") <= 10_000).sum("bal"),
              lambda F, x: x.query().min("bal"),
              lambda F, x: x.query().max("bal")):
        assert q(TK.F, t.table("row")) == q(RK.F, r.table("row"))
    assert isinstance(t.table("row")._t.segments[0].scanner_(),
                      ShardedScanner)
    r.close()
    t.close()


def test_series_on_mesh():
    """run_series through a mesh-attached engine == the reference's plain
    engine: counts, exact sums, first / last / last_join across shard
    edges."""
    import knoxdb_tpu.series as RSER
    import knoxdb_tpu_torch.series as TSER

    @dataclass
    class TRow:
        id: int = 0
        ts: int = 0
        v: int = 0

    rng = np.random.default_rng(0xC0FFEE)
    n = 8000
    ts = (rng.integers(0, 1000, n) // 5) * 5
    v = rng.integers(-10 ** 6, 10 ** 6, n)
    outs = []
    for K, SER, kw in ((RK, RSER, {}), (TK, TSER, {"device": "cpu",
                                                  "mesh": CPU8})):
        db = K.create_database("ser", driver="mem", pack_size=512,
                               background_merge=False, **kw)
        tab = db.create_table(TRow)
        tab.insert({"id": np.zeros(n, np.uint64), "ts": ts.copy(),
                    "v": v.copy()})
        tab.merge()
        req = SER.SeriesRequest(table=tab, time_field="ts", start=0,
                                end=1000, interval=100,
                                aggs=[("count", ""), ("sum", "v"),
                                      ("first", "v"), ("last", "v"),
                                      ("last_join", "v"), ("var", "v")],
                                fill=SER.FillMode.NULL)
        outs.append(SER.run_series(req))
        db.close()
    a, b = outs
    np.testing.assert_array_equal(a["count"], b["count"])
    for key in (("sum", "v"), ("first", "v"), ("last", "v"),
                ("last_join", "v"), ("var", "v")):
        assert list(a[key]) == list(b[key]), key


def test_dryrun_scenario(monkeypatch):
    """__graft_entry__.dryrun_multichip's table part at n = 16,384: the
    port's mesh-attached database == the reference's single-device one ==
    the port's own single-device one; the join takes the shuffle
    branch."""
    calls = []
    real = TSH.shuffle_join_rows

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out[2]["core"])
        return out
    monkeypatch.setattr(TSH, "shuffle_join_rows", spy)
    ref, _w, rdb = dryrun_tables(RK, "dry_r")
    one, _w, odb = dryrun_tables(TK, "dry_1", device="cpu")
    assert calls == []
    mesh, _w, mdb = dryrun_tables(TK, "dry_m", device="cpu", mesh=CPU8)
    assert calls == ["unique"]
    assert isinstance(mdb.table("acct")._t.segments[0].scanner_(),
                      ShardedScanner)
    same(one, mesh)
    same(ref, mesh)
    for db in (rdb, odb, mdb):
        db.close()


def test_mesh_stores_equal_reference_blobs(tmp_path):
    """Mesh-attached engines of both packages write the same files: WAL,
    catalog and the uniform segments' blobs, byte for byte."""
    from knoxdb_tpu.parallel.shard import make_mesh as r_make_mesh
    p = Pair(tmp_path, "blobs", [("val", "UINT64"), ("bal", "INT64"),
                                 ("px", "FLOAT64"), ("name", "STRING")],
             side_opts={"ref": {"mesh": r_make_mesh(NDEV)},
                        "port": {"mesh": CPU8}})
    rng = np.random.default_rng(9)
    for b in range(3):
        n = 700 + 311 * b
        p.insert({"id": np.arange(1, n + 1, dtype=np.uint64) + 10_000 * b,
                  "val": rng.integers(0, 1 << 20, n, dtype=np.uint64),
                  "bal": rng.integers(-1 << 40, 1 << 40, n),
                  "px": rng.integers(-10 ** 6, 10 ** 6, n) / 100.0,
                  "name": [f"n{i % 13}" for i in range(n)]})
        p.merge()
    assert all(h.seg.npacks % NDEV == 0 for h in p.tab["port"].segments)
    p.close()
    p.same_files()


def test_mesh_across_processes_raises(monkeypatch):
    """With a torch.distributed group of world size 2 (patched; no process
    starts) every collective, the scanner, the shuffle and hybrid_mesh
    raise NotImplementedError naming the ROADMAP item."""
    from knoxdb_tpu_torch.exec.device import DeviceSegment
    from knoxdb_tpu_torch.exec.scan import AggSpec
    from knoxdb_tpu_torch.pack.segment import build_segment
    from knoxdb_tpu_torch.schema.schema import Builder
    from knoxdb_tpu_torch.types import FieldType
    sch = Builder("w").pk("id").add("v", FieldType.UINT64).finish()
    seg = build_segment(sch, {"id": np.arange(1, 3001, dtype=np.uint64),
                              "v": np.arange(3000, dtype=np.uint64)}, 256,
                        uniform=NDEV)
    sc = ShardedScanner(DeviceSegment(seg, "cpu"), CPU8)
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    for call in (lambda: CPU8.psum([1]),
                 lambda: CPU8.concat([torch.zeros(1)], "cpu"),
                 lambda: CPU8.all_to_all([torch.zeros(8, 1)] * NDEV),
                 lambda: sc.scan(None, [AggSpec("count")]),
                 lambda: TSH.shuffle_join_rows(
                     CPU8, np.arange(10, dtype=np.uint64),
                     np.arange(10, dtype=np.uint64), axis="packs"),
                 lambda: hybrid_mesh(devices=["cpu"] * 8)):
        with pytest.raises(NotImplementedError, match="11b"):
            call()
