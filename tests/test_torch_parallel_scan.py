"""knoxdb_tpu_torch's parallel scan on a mesh of eight CPU shards: the
shard-uniform build_segment(uniform=N) against the reference's, and the
ShardedScanner against the reference's single-device scanner on the very
same uniform packs (the reference's own tests hold its mesh path equal to
that), with sharded_range_scan once against the reference's 8-device
virtual mesh.

Tolerance 0 throughout: counts, exact sums, min and max, float sums (ALP
rationals; keyform float sums in a fixed pairwise order per pack),
projected rows and their positions in order, stream batches, group
partials on both routes, top-k rows with ties across shard edges, and
the series kinds (exact moments and first / last against the reference,
every kind against the port's single-device scanner)."""

import numpy as np
import pytest
import torch

from knoxdb_tpu.exec import sort as RSort
from knoxdb_tpu.exec.device import DeviceSegment as RDevSeg
from knoxdb_tpu.exec.scan import AggSpec as RAgg
from knoxdb_tpu.exec.scan import SegmentScanner as RScanner
from knoxdb_tpu.exec import groupby as RGB
from knoxdb_tpu.pack.segment import build_segment as r_build
from knoxdb_tpu.query import filter as RQ
from knoxdb_tpu.schema.schema import Builder as RBuilder
from knoxdb_tpu.types import FieldType as RFT
from knoxdb_tpu.types import FilterMode as RFM
from knoxdb_tpu_torch.exec import groupby as TGB
from knoxdb_tpu_torch.exec import sort as TSort
from knoxdb_tpu_torch.exec.device import DeviceSegment as TDevSeg
from knoxdb_tpu_torch.exec.scan import AggSpec as TAgg
from knoxdb_tpu_torch.exec.scan import SegmentScanner as TScanner
from knoxdb_tpu_torch.ops import bitset as TBS
from knoxdb_tpu_torch.ops import scan_kernels as SK
from knoxdb_tpu_torch.pack import segment as TSEG
from knoxdb_tpu_torch.parallel import (Mesh, ShardedScanner,
                                       is_uniform_segment, make_mesh)
from knoxdb_tpu_torch.parallel import shard as TPS
from knoxdb_tpu_torch.query import filter as TQ
from knoxdb_tpu_torch.schema.schema import Builder as TBuilder
from knoxdb_tpu_torch.types import FieldType as TFT
from knoxdb_tpu_torch.types import FilterMode as TFM
from test_torch_segment import assert_segments_equal

NDEV = 8
CPU8 = Mesh([torch.device("cpu")] * NDEV, ("packs",))
PACK = 512


def _schema(B, FT, cols):
    b = B("u").pk("id")
    for name, ft in cols:
        b = b.add(name, FT[ft])
    return b.finish()


def _case(kind, n, rng):
    """(columns, data) of one uniform-build case."""
    ids = np.arange(1, n + 1, dtype=np.uint64)
    if kind == "narrow":
        return ([("val", "UINT64"), ("bal", "INT64"), ("grp", "UINT16")],
                {"id": ids, "val": rng.integers(0, 50_000, n, dtype=np.uint64),
                 "bal": rng.integers(-1 << 40, 1 << 40, n),
                 "grp": rng.integers(0, 20, n).astype(np.uint16)})
    if kind == "int128":
        vals = [int(v) * (10 ** 25 // 7) for v in
                rng.integers(-10 ** 6, 10 ** 6, n)]
        return [("amt", "INT128")], {"id": ids, "amt": vals}
    if kind == "int128_raw":
        vals = [int(v) << 70 for v in rng.integers(-10 ** 6, 10 ** 6, n)]
        return [("amt", "INT128")], {"id": ids, "amt": vals}
    if kind == "strings":
        return [("name", "STRING")], {
            "id": ids, "name": [f"acct-{i % 97:03d}" for i in range(n)]}
    if kind == "floats":
        return ([("px", "FLOAT64"), ("lat", "FLOAT64")],
                {"id": ids,
                 "px": rng.integers(-10 ** 6, 10 ** 6, n) / 100.0,
                 "lat": rng.standard_normal(n) * 90.0})
    raise ValueError(kind)


@pytest.mark.parametrize("kind,n", [("narrow", 20_000), ("narrow", 3 * PACK),
                                    ("int128", 3000), ("int128_raw", 2000),
                                    ("strings", 5000), ("floats", 9000),
                                    ("narrow", 1)])
def test_uniform_build_matches_reference(kind, n):
    """N does not divide P in every case: the pad packs are empty."""
    rng = np.random.default_rng(0xC0FFEE)
    cols, data = _case(kind, n, rng)
    rseg = r_build(_schema(RBuilder, RFT, cols), data, PACK, uniform=NDEV)
    tseg = TSEG.build_segment(_schema(TBuilder, TFT, cols), data, PACK,
                              uniform=NDEV)
    assert tseg.npacks % NDEV == 0 and tseg.npacks > -(-n // PACK) - 1
    assert_segments_equal(rseg, tseg)
    ds = TDevSeg(tseg, "cpu")
    assert is_uniform_segment(ds, NDEV)
    assert all(len(ds.column(c).groups) == 1 for c in tseg.columns)


def test_is_uniform_segment():
    rng = np.random.default_rng(1)
    cols, data = _case("narrow", 20_000, rng)
    data["val"][:PACK] = 7                 # one CONST pack: two groups
    sch = _schema(TBuilder, TFT, cols)
    plain = TDevSeg(TSEG.build_segment(sch, data, PACK), "cpu")
    assert not is_uniform_segment(plain, NDEV)
    with pytest.raises(ValueError, match="uniform"):
        ShardedScanner(plain, CPU8)
    uni = TDevSeg(TSEG.build_segment(sch, data, PACK, uniform=NDEV), "cpu")
    assert is_uniform_segment(uni, NDEV)
    assert not is_uniform_segment(uni, 3)
    assert is_uniform_segment(uni, 4)


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_count"):
        make_mesh(1)
    m = make_mesh(devices=["cpu"] * 3)
    assert m.shape == {"packs": 3} and m.axis_names == ("packs",)


def test_sharded_range_scan_against_reference_mesh():
    """The reference's shard_map scan on its 8-device virtual CPU mesh and
    the port's per-shard kernel #1 give the same (count, exact sum)."""
    import jax.numpy as jnp
    from knoxdb_tpu.encode import schemes as RS
    from knoxdb_tpu.parallel import shard as RPS
    rng = np.random.default_rng(0xC0FFEE)
    P, width = NDEV * 3, 10
    vals = rng.integers(0, 1 << width, (P, PACK), dtype=np.uint64)
    mins = rng.integers(0, 1000, P, dtype=np.uint64)
    vals_abs = vals + mins[:, None]
    planes = np.stack([RS.encode_bitpack(vals_abs[p], 1, int(mins[p]), width,
                                         PACK).planes for p in range(P)],
                      axis=1)
    valid = np.full((P, PACK // 32), 0xFFFFFFFF, np.uint32)
    valid[-1, 5:] = 0
    lo, hi = 600, 1600
    want = RPS.sharded_range_scan(
        RPS.make_mesh(NDEV), jnp.asarray(planes), jnp.asarray(mins),
        jnp.asarray(valid), lo, hi, width)
    SK.reset_counts()
    got = TPS.sharded_range_scan(CPU8, planes, mins, valid, lo, hi, width)
    assert got == tuple(int(x) for x in want)
    assert SK.PLAIN_CALLS["fused_range_sum_masked"] == NDEV
    m = (vals_abs >= lo) & (vals_abs <= hi)
    m[-1, 5 * 32:] = False
    assert got == (int(m.sum()), int(vals_abs[m].astype(object).sum()))


# ------------------------------------------------------ the scanner ---

COLS = [("val", "UINT64"), ("bal", "INT64"), ("grp", "UINT16"),
        ("ts", "UINT64"), ("px", "FLOAT64"), ("lat", "FLOAT64"),
        ("amt", "INT128"), ("name", "STRING")]


class Pair:
    """One reference uniform segment: the reference's single-device
    scanner, the port's ShardedScanner on eight CPU shards and the port's
    single-device scanner."""

    def __init__(self):
        rng = np.random.default_rng(0x5EED)
        n = 37 * PACK + 123                      # 38 packs, padded to 40
        self.n = n
        self.data = {
            "id": np.arange(1, n + 1, dtype=np.uint64),
            "val": rng.integers(0, 50_000, n, dtype=np.uint64),
            "bal": rng.integers(-1 << 40, 1 << 40, n),
            # few distinct values: ties inside and across shard edges
            "grp": rng.integers(0, 20, n).astype(np.uint16),
            "ts": (1000 + rng.integers(0, 600, n)).astype(np.uint64),
            "px": rng.integers(-10 ** 6, 10 ** 6, n) / 100.0,
            "lat": rng.standard_normal(n) * 90.0,
            "amt": [int(v) * (10 ** 25 // 7)
                    for v in rng.integers(-10 ** 6, 10 ** 6, n)],
            "name": [f"acct-{i % 97:03d}" for i in range(n)],
        }
        self.rsch = _schema(RBuilder, RFT, COLS)
        self.rseg = r_build(self.rsch, self.data, PACK, uniform=NDEV)
        self.tseg = TSEG.segment_from_reference(self.rseg)
        self.rsc = RScanner(RDevSeg(self.rseg))
        self.msc = ShardedScanner(TDevSeg(self.tseg, "cpu"), CPU8)
        self.tsc = TScanner(TDevSeg(self.tseg, "cpu"))
        P = self.tseg.npacks
        rows = rng.random(P * PACK) < 0.1
        self.excl = TBS.np_pack_mask(rows).reshape(P, -1)

    def trees(self, spec):
        def build(Q, FM, sch, s):
            if s is None:
                return None
            if s[0] == "leaf":
                return Q.leaf(Q.Filter(sch.field(s[1]), FM[s[2]], s[3]))
            kids = [build(Q, FM, sch, c) for c in s[1:]]
            return (Q.and_ if s[0] == "and" else Q.or_)(*kids)

        def opt(t):
            return None if t is None else t.optimize()
        return (opt(build(RQ, RFM, self.rsch, spec)),
                opt(build(TQ, TFM, self.tseg.schema, spec)))


@pytest.fixture(scope="module")
def pair():
    return Pair()


SPECS = [
    (("leaf", "val", "GT", 25_000), True),
    (("and", ("leaf", "val", "RANGE", (100, 10_000)),
      ("leaf", "bal", "GT", 0)), False),
    (("or", ("leaf", "val", "LT", 50), ("leaf", "grp", "IN", [1, 5, 19])),
     False),
    (("and", ("leaf", "px", "GT", 5000.0), ("leaf", "px", "LE", 9000.25)),
     False),
    (("leaf", "name", "GE", "acct-090"), False),
    (("leaf", "amt", "GT", 0), True),
]
AGGS = [("count", ""), ("sum", "val"), ("sum", "bal"), ("min", "bal"),
        ("max", "val"), ("sum", "px"), ("sum", "lat"), ("max", "lat"),
        ("sum", "amt"), ("min", "amt")]


@pytest.mark.parametrize("spec,excl", SPECS, ids=str)
def test_scan_aggregates_equal_reference(pair, spec, excl):
    rt, tt = pair.trees(spec)
    ex = pair.excl if excl else None
    SK.reset_counts()
    r = pair.rsc.scan(rt, [RAgg(*a) for a in AGGS], exclude_words=ex)
    t = pair.msc.scan(tt, [TAgg(*a) for a in AGGS], exclude_words=ex)
    assert t.count == r.count
    assert list(t.aggs.values()) == list(r.aggs.values())
    assert t.stats["packs_matched"] == r.stats["packs_matched"]
    # every shard ran the single-device plan: the fused kernel once per
    # shard, the popcount kernel (5b) once per shard for the ALP sum of px
    # (amt's range passes 2^63: RAW packs), the ladder (5a) once per shard
    # per unfused range leaf
    assert SK.PLAIN_CALLS["fused_range_sum_masked"] \
        + SK.PLAIN_CALLS["fused_tree_agg"] == NDEV
    assert SK.PLAIN_CALLS["masked_plane_popcounts"] == NDEV
    assert SK.PLAIN_CALLS["range_mask_count"] % NDEV == 0
    if spec[0] == "or":
        assert SK.PLAIN_CALLS["range_mask_count"] == NDEV


@pytest.mark.parametrize("limit", [0, 37, 1000])
def test_projection_rows_in_order(pair, limit):
    rt, tt = pair.trees(("leaf", "val", "LT", 3000))
    proj = ["val", "bal", "px", "amt", "name"]
    r = pair.rsc.scan(rt, [RAgg("count")], project=proj, limit=limit,
                      exclude_words=pair.excl)
    t = pair.msc.scan(tt, [TAgg("count")], project=proj, limit=limit,
                      exclude_words=pair.excl)
    np.testing.assert_array_equal(t.row_ids, np.asarray(r.row_ids))
    for name in proj:
        assert list(t.rows[name]) == list(r.rows[name]), name


def test_scan_stream_batches(pair):
    rt, tt = pair.trees(("leaf", "grp", "LE", 3))
    rb = list(pair.rsc.scan_stream(rt, ["val", "name"], batch_packs=3))
    tb = list(pair.msc.scan_stream(tt, ["val", "name"], batch_packs=3))
    assert len(tb) == len(rb)
    for a, b in zip(rb, tb):
        assert b.count == a.count
        np.testing.assert_array_equal(b.row_ids, np.asarray(a.row_ids))
        for name in ("val", "name"):
            assert list(b.rows[name]) == list(a.rows[name])


@pytest.mark.parametrize("minmax", [False, True])
@pytest.mark.parametrize("gfield,afields", [("grp", ["bal", "val"]),
                                            ("name", ["bal"]),
                                            ("ts", [])])
def test_group_scan_equal_reference(pair, gfield, afields, minmax):
    rt, tt = pair.trees(("leaf", "val", "GT", 500))
    SK.reset_counts()
    from knoxdb_tpu_torch.ops import group_kernels as GK
    GK.reset_counts()
    rp, rc, rres = pair.rsc.group_scan(rt, gfield, afields,
                                       exclude_words=pair.excl,
                                       minmax=minmax)
    tp, tc, tres = pair.msc.group_scan(tt, gfield, afields,
                                       exclude_words=pair.excl,
                                       minmax=minmax)
    assert tp.G == rp.G
    np.testing.assert_array_equal(tc, np.asarray(rc))
    assert sorted(tres) == sorted(rres)
    for f in rres:
        rs, rmn, rmx = rres[f]
        ts, tmn, tmx = tres[f]
        assert list(ts) == [int(x) for x in rs], f
        if minmax:
            np.testing.assert_array_equal(tmn, np.asarray(rmn))
            np.testing.assert_array_equal(tmx, np.asarray(rmx))
    if not minmax:
        # the group kernel's plain version, once per shard and field
        assert GK.PLAIN_CALLS["fused_group_partials"] == \
            NDEV * max(len(afields), 1)


def _series_both(pair, kinds, spec, excl):
    gp = TGB.plan_buckets(pair.msc.d, "ts", 1000, 64, 10)
    rt, tt = pair.trees(spec)
    m = pair.msc.series_scan(tt, "ts", kinds, gp, exclude_words=excl)
    s = pair.tsc.series_scan(tt, "ts", kinds, gp, exclude_words=excl)
    return gp, m, s


@pytest.mark.parametrize("excl", [False, True])
def test_series_every_kind(pair, excl):
    """Every kind on the mesh equals the port's single device bit for bit;
    the exact moments (val's range fits 32 bits) and first / last also
    equal the reference."""
    kinds = {"bal": {"moments", "firstlast", "tsruns"},
             "val": {"moments", "fminmax"},
             "px": {"moments", "firstlast", "fminmax", "tsruns"},
             "lat": {"moments", "fminmax"}}
    ex = pair.excl if excl else None
    spec = ("leaf", "grp", "LT", 15)
    gp, m, s = _series_both(pair, kinds, spec, ex)
    assert sorted(m) == sorted(s)
    for key in s:
        for a, b in zip(m[key], s[key]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=str(key))
    rgp = RGB.plan_buckets(RDevSeg(pair.rseg), "ts", 1000, 64, 10)
    rt, _tt = pair.trees(spec)
    r = pair.rsc.series_scan(rt, "ts", {"bal": {"firstlast"},
                                         "val": {"moments"}}, rgp,
                             exclude_words=ex)
    for key in (("val", "moments"), ("bal", "firstlast")):
        for a, b in zip(m[key], r[key]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=str(key))


@pytest.mark.parametrize("field,desc", [("grp", False), ("grp", True),
                                        ("val", True), ("id", False)])
def test_topk_ties_across_shard_edges(pair, field, desc):
    rt, tt = pair.trees(("leaf", "bal", "GT", -(1 << 39)))
    k = 3 * PACK                     # the k-th place falls past shard 0
    r = RSort.segment_topk(pair.rsc, rt, field, k, desc=desc,
                           project=["val", "grp"])
    t = TSort.segment_topk(pair.msc, tt, field, k, desc=desc,
                           project=["val", "grp"])
    assert t[2] == r[2] and t[0] == [int(x) for x in r[0]]
    for name in r[1]:
        np.testing.assert_array_equal(np.asarray(t[1][name]),
                                      np.asarray(r[1][name]), err_msg=name)


def test_no_column_held_twice(pair):
    """After every path above, the scanner's image of the whole segment
    still holds host metadata only: each column's data lives once, in the
    shards (placed at construction, pack ranges in shard order)."""
    assert not pair.msc.d.with_arrays
    assert set(pair.msc.d.columns) >= {"val", "bal", "grp", "px", "name"}
    for col in pair.msc.d.columns.values():
        assert all(not g.arrays for g in col.groups)
    P = pair.tseg.npacks
    assert pair.msc.ranges == [(r * P // NDEV, (r + 1) * P // NDEV)
                               for r in range(NDEV)]
    for sh, (lo, hi) in zip(pair.msc.shards, pair.msc.ranges):
        g = sh.d.column("val").groups[0]
        assert g.arrays["planes"].is_contiguous()
        np.testing.assert_array_equal(
            g.arrays["planes"].numpy().view(np.uint32),
            np.stack([p.planes for p in
                      pair.tseg.columns["val"].packs[lo:hi]], axis=1))
