"""knoxdb_tpu_torch's Table reads against knoxdb_tpu's over one layout
of two sealed segments (one with dead rows), an update and a committed
journal batch with tombstones over sealed rows: query (aggregates and
projected rows), group_query, sorted_query (top-k and full orders),
stream_query, and join_side + join_pairs_device + rows_at_positions
(mirrors the read paths of tests/test_knox.py and tests/test_join.py at
the Table level). The port's engine runs on the CPU here."""

import numpy as np
import pytest

import knoxdb_tpu.exec.join as RJ
import knoxdb_tpu_torch.exec.join as TJ

from torch_engine_pair import SIDES, Pair, leaf, same, tree


# ----------------------------------------- reads over segments + journal --

MIX = [("v", "INT64"), ("u", "UINT32"), ("g", "UINT16"), ("x", "FLOAT64"),
       ("s", "STRING")]


def _mix_data(rng, n, start):
    return {"id": np.arange(start, start + n, dtype=np.uint64),
            "v": rng.integers(-1 << 40, 1 << 40, n),
            "u": rng.integers(0, 1 << 20, n).astype(np.uint32),
            "g": rng.integers(0, 12, n).astype(np.uint16),
            "x": np.round(rng.normal(0, 50, n), 2),
            "s": [f"k{int(i) % 23}" for i in rng.integers(0, 1000, n)]}


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Two sealed segments, one with dead rows, an update, and a
    committed journal batch with tombstones over sealed rows."""
    rng = np.random.default_rng(0x5EED)
    p = Pair(tmp_path_factory.mktemp("mixed"), "mix", MIX)
    p.insert(_mix_data(rng, 1300, 1))
    p.merge()
    p.insert(_mix_data(rng, 1200, 2001))
    p.merge()
    p.delete(leaf("u", "LT", 3000))
    p.merge()
    p.update({k: v[:30] if not isinstance(v, list) else v[:30]
              for k, v in _mix_data(rng, 30, 2001).items()})
    p.insert(_mix_data(rng, 200, 5001))
    p.delete(("or", leaf("g", "EQ", 3), leaf("v", "GT", 1 << 39)))
    yield p
    p.close()


def test_mixed_layout(mixed):
    segs = mixed.segments()
    assert len(segs) == 2 and any(d for _, d in segs)
    assert not mixed.tab["port"].journal.is_empty()


@pytest.mark.parametrize("spec", [
    None,
    leaf("u", "RANGE", (1000, 500000)),
    ("and", leaf("v", "LT", 0), leaf("g", "IN", [1, 2, 5])),
    ("or", leaf("u", "GT", 900000), leaf("x", "LT", -40.0)),
    leaf("s", "EQ", "k7"),
])
def test_query_aggregates_and_rows(mixed, spec):
    r = mixed.query(spec, [("count",), ("sum", "v"), ("sum", "u"),
                           ("min", "v"), ("max", "u"), ("avg", "v"),
                           ("sum", "x"), ("min", "x")],
                    project=["id", "v", "x", "s"])
    assert r.count == len(r.rows["id"])
    mixed.query(spec, project=["id", "g"], limit=17)


@pytest.mark.parametrize("gfield,aggs", [
    ("g", [("count", ""), ("sum", "v"), ("min", "v"), ("max", "u"),
           ("avg", "u")]),
    ("g", [("sum", "x"), ("avg", "x"), ("min", "x"), ("max", "x"),
           ("var", "v"), ("std", "u")]),
    ("s", [("count", ""), ("sum", "u"), ("max", "v")]),
])
def test_group_query(mixed, gfield, aggs):
    """Exact aggregates equal; float sums and moments (f64 in a fixed
    order that differs between the packages) within the reference's
    series tolerance, 64 eps * sum|v| per group."""
    spec = leaf("u", "GT", 1000)
    floats = [k for k in aggs if k[1] == "x" and k[0] in ("sum", "avg")
              or k[0] in ("var", "std")]
    out = {}
    for side in SIDES:
        e, t = mixed.eng[side], mixed.tab[side]
        with e.begin(read_only=True) as tx:
            out[side] = t.group_query(tx.snapshot, tree(side, t.schema, spec),
                                      gfield, list(aggs))
    r, o = out["ref"], out["port"]
    same({k: v for k, v in r.items() if k not in floats},
         {k: v for k, v in o.items() if k not in floats})
    assert len(o["keys"]) == len(o["count"]) > 1
    if floats:
        rows = mixed.query(spec, project=[gfield, "x", "v", "u"]).rows
        for op, f in floats:
            vals = rows[f].astype(np.float64)
            scale = np.array([np.abs(vals[rows[gfield] == k]).sum()
                              + np.square(vals[rows[gfield] == k]).sum()
                              * (op in ("var", "std"))
                              for k in o["keys"]])
            got = np.array(o[(op, f)].tolist(), np.float64)
            want = np.array(r[(op, f)].tolist(), np.float64)
            np.testing.assert_array_less(
                np.abs(got - want), 64 * np.finfo(np.float64).eps * scale
                + 1e-300)


@pytest.mark.parametrize("order_by,desc,limit", [
    ("v", False, 10), ("u", True, 25), ("x", False, 7), ("v", True, 0),
    ("s", False, 12)])
def test_sorted_query(mixed, order_by, desc, limit):
    r = mixed.sorted(leaf("g", "NE", 4), order_by, desc=desc, limit=limit,
                     project=["id", order_by])
    assert r.count == len(r.rows["id"])


def test_stream_query(mixed):
    batches = mixed.stream(leaf("u", "GT", 200000), ["id", "u", "s"])
    assert sum(len(b["id"]) for b in batches) \
        == mixed.count(leaf("u", "GT", 200000))
    mixed.stream(None, ["id", "x"], limit=333)


def test_join_side_pairs_and_rows(mixed):
    """tx join: keys and positions of the join column from segments and
    journal, joined on the device, every pair's rows materialized."""
    got = {}
    for side in SIDES:
        e, t = mixed.eng[side], mixed.tab[side]
        J = RJ if side == "ref" else TJ
        with e.begin(read_only=True) as tx:
            lk, lp, lv = t.join_side(tx.snapshot, tree(side, t.schema, leaf(
                "u", "GT", 500000)), "g")
            rk, rp, rv = t.join_side(tx.snapshot, tree(side, t.schema, leaf(
                "g", "LT", 3)), "id")
        li, ri = J.join_pairs_device(lk, rk)
        lpos = np.asarray(lp if side == "ref" else lp.numpy())[li]
        rpos = np.asarray(rp if side == "ref" else rp.numpy())[ri]
        lrows = t.rows_at_positions(lv, lpos, ["id", "v"])
        rrows = t.rows_at_positions(rv, rpos, ["s", "x"])
        pairs = sorted(zip(lpos.tolist(), rpos.tolist(),
                           lrows["id"].tolist(), lrows["v"].tolist(),
                           rrows["s"].tolist(), rrows["x"].tolist()))
        keys = np.sort(np.asarray(lk if side == "ref" else lk.numpy())
                       .view(np.uint64))
        got[side] = (pairs, keys)
    same(got["ref"], got["port"])
    assert len(got["port"][0]) > 0


def test_join_side_signed_keys(tmp_path, rng):
    """INT64 keys map to two's-complement values: negative foreign keys
    match the same values in another table."""
    a = Pair(tmp_path / "a", "ja", [("k", "INT64")])
    b = Pair(tmp_path / "b", "jb", [("k", "INT64")])
    ka = rng.integers(-50, 50, 700)
    kb = np.arange(-60, 60, dtype=np.int64)
    a.insert({"id": np.zeros(700, np.uint64), "k": ka})
    a.merge()
    a.insert({"id": np.zeros(5, np.uint64), "k": np.array([-3, 0, 3, -60,
                                                           59])})
    b.insert({"id": np.zeros(120, np.uint64), "k": kb})
    b.merge()
    got = {}
    for side in SIDES:
        J = RJ if side == "ref" else TJ
        with a.eng[side].begin(read_only=True) as tx:
            lk, lp, _ = a.tab[side].join_side(tx.snapshot, None, "k")
        with b.eng[side].begin(read_only=True) as tx:
            rk, rp, _ = b.tab[side].join_side(tx.snapshot, None, "k")
        li, ri = J.join_pairs_device(lk, rk, unique_build=True)
        got[side] = sorted(zip(np.asarray(lp if side == "ref"
                                          else lp.numpy())[li].tolist(),
                               np.asarray(rp if side == "ref"
                                          else rp.numpy())[ri].tolist()))
    same(got["ref"], got["port"])
    assert len(got["port"]) == 705
    a.close()
    b.close()
