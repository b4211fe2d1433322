"""knoxdb_tpu_torch's row-id sets, hashes and pack filters (BFUSE8/16,
BITS, bloom) against knoxdb_tpu: the same sets, fingerprints, prune
decisions and pruned scans (mirrors tests/test_ridset.py, the fuse half of
tests/test_csv_fuse.py, tests/test_filters_wired.py and
tests/test_stats_tree.py)."""

import numpy as np
import pytest
import torch

import knoxdb_tpu.filter.fuse as RFU
import knoxdb_tpu.ops.hash as RH
import knoxdb_tpu.pack.stats as RST
import knoxdb_tpu.utils.ridset as RRS
import knoxdb_tpu_torch.filter.fuse as TFU
import knoxdb_tpu_torch.ops.hash as TH
import knoxdb_tpu_torch.pack.stats as TST
import knoxdb_tpu_torch.utils.ridset as TRS
from knoxdb_tpu.exec.device import DeviceSegment as RDevSeg
from knoxdb_tpu.exec.scan import AggSpec as RAgg
from knoxdb_tpu.exec.scan import SegmentScanner as RScanner
from knoxdb_tpu.pack.segment import build_segment as r_build
from knoxdb_tpu.query import filter as RQ
from knoxdb_tpu.schema.schema import Builder as RBuilder
from knoxdb_tpu.types import FieldType as RFT
from knoxdb_tpu.types import FilterMode as RFM
from knoxdb_tpu.types import FilterType as RFL
from knoxdb_tpu_torch.exec.device import DeviceSegment as TDevSeg
from knoxdb_tpu_torch.exec.scan import AggSpec as TAgg
from knoxdb_tpu_torch.exec.scan import SegmentScanner as TScanner
from knoxdb_tpu_torch.filter import bloom as TBL
from knoxdb_tpu_torch.ops import words as WD
from knoxdb_tpu_torch.pack.segment import build_segment as t_build
from knoxdb_tpu_torch.pack.segment import segment_from_reference
from knoxdb_tpu_torch.query import filter as TQ
from knoxdb_tpu_torch.schema.schema import Builder as TBuilder
from knoxdb_tpu_torch.schema.schema import field_meta
from knoxdb_tpu_torch.types import FieldType as TFT
from knoxdb_tpu_torch.types import FilterMode as TFM
from knoxdb_tpu_torch.types import FilterType as TFL
from knoxdb_tpu_torch.utils import limbs as lb

N = 2048
PACK = 512


# --------------------------------------------------------------- RidSet --

def _rids(rng, seed_kind):
    sparse = rng.choice(1 << 24, 5000, replace=False).astype(np.uint64)
    dense = (np.uint64(7 << 16) + rng.choice(
        1 << 16, TRS._CUTOFF + 500, replace=False).astype(np.uint64))
    if seed_kind == "sparse":
        return sparse
    if seed_kind == "dense":
        return dense
    return np.concatenate([sparse, dense, sparse[:100]])


@pytest.mark.parametrize("kind", ["sparse", "dense", "mixed"])
def test_ridset_equal(rng, kind):
    rids = _rids(rng, kind)
    r, t = RRS.RidSet.from_array(rids), TRS.RidSet.from_array(rids)
    assert len(t) == len(r) == len(np.unique(rids))
    assert t.nbytes == r.nbytes
    np.testing.assert_array_equal(t.to_array(), r.to_array())
    np.testing.assert_array_equal(t._keys, r._keys)
    for a, b in zip(t._containers, r._containers):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    probe = np.concatenate([rng.integers(0, 1 << 24, 10_000,
                                         dtype=np.uint64), rids[:50]])
    np.testing.assert_array_equal(t.isin(probe), r.isin(probe))
    np.testing.assert_array_equal(t.isin(probe), np.isin(probe, rids))
    np.testing.assert_array_equal(t.intersect_array(probe),
                                  r.intersect_array(probe))
    if kind == "sparse":
        assert t.nbytes < (1 << 24) // 8


def test_ridset_union_and_empty():
    a = TRS.RidSet.from_array(np.array([1, 5, 9], np.uint64))
    b = TRS.RidSet.from_array(np.array([5, 100_000], np.uint64))
    ra = RRS.RidSet.from_array(np.array([1, 5, 9], np.uint64))
    rb = RRS.RidSet.from_array(np.array([5, 100_000], np.uint64))
    np.testing.assert_array_equal(a.union(b).to_array(),
                                  ra.union(rb).to_array())
    e = TRS.RidSet.empty()
    assert len(e) == 0 and not e.isin(np.array([1], np.uint64)).any()
    assert e.union(a) is a and a.union(e) is a


# --------------------------------------------------------------- hashes --

def test_hashes_equal(rng):
    limbs = rng.integers(0, 1 << 32, (2, 5000), dtype=np.uint64) \
        .astype(np.uint32)
    x = limbs[0]
    np.testing.assert_array_equal(TH.mix32(x, np), RH.mix32(x, np))
    for seed in (0, 0x8BADF00D, 7):
        np.testing.assert_array_equal(TH.hash32_np(limbs, seed),
                                      RH.hash32_np(limbs, seed))
    # device versions: int32-carried words, the same bits
    tl = WD.to_words(limbs, "cpu")
    np.testing.assert_array_equal(WD.from_words(TH.hash32(tl, 5)),
                                  RH.hash32_np(limbs, 5))
    h1, h2 = TH.hash2(tl)
    r1, r2 = RH.hash2_np(limbs)
    np.testing.assert_array_equal(WD.from_words(h1), r1)
    np.testing.assert_array_equal(WD.from_words(h2), r2)
    np.testing.assert_array_equal(
        WD.from_words(TH.mix32(WD.to_words(x, "cpu"), torch)),
        RH.mix32(x, np))


# ----------------------------------------------------------- xor filter --

@pytest.mark.parametrize("fp_bits", [8, 16])
def test_xor_filter_equal(rng, fp_bits):
    keys = np.unique(rng.integers(0, 1 << 60, 5000, dtype=np.uint64))
    limbs = lb.to_keyform(keys, TFT.UINT64)
    t, r = TFU.build(limbs, fp_bits), RFU.build(limbs, fp_bits)
    assert t.seed == r.seed and t.fp.dtype == r.fp.dtype
    np.testing.assert_array_equal(t.fp, r.fp)
    assert t.contains_limbs(limbs).all()
    probe = rng.integers(1 << 61, 1 << 62, 30000, dtype=np.uint64)
    pl = lb.to_keyform(probe, TFT.UINT64)
    np.testing.assert_array_equal(t.contains_limbs(pl),
                                  r.contains_limbs(pl))
    assert t.contains_limbs(pl).mean() < 0.02
    if fp_bits == 8:
        assert t.nbytes * 8 / len(keys) < 14


def test_xor_filter_bytes_and_dups():
    vals = [b"alpha", b"beta", b"alpha", b"gamma"] * 50
    t, r = TFU.build_bytes(vals), RFU.build_bytes(vals)
    np.testing.assert_array_equal(t.fp, r.fp)
    from knoxdb_tpu_torch.filter.bloom import _bytes_hashes
    h1, h2 = _bytes_hashes(list(set(vals)))
    assert t.contains_hashes(h1, h2).all()
    assert t.contains_bytes([b"delta"]) == r.contains_bytes([b"delta"])


# ------------------------------------------- pack filters in segments --

def _data(rng, dtype=np.uint64):
    # disjoint value ranges per pack so EQ probes hit exactly one pack
    vals = np.concatenate([
        rng.choice(np.arange(p * 100000, p * 100000 + 50000, 2,
                             dtype=dtype), PACK) for p in range(N // PACK)])
    return {"id": np.arange(1, N + 1, dtype=np.uint64), "v": vals}


def _segs(kind, data):
    rsch = RBuilder("t").pk("id").add("v", RFT.UINT64,
                                      filter=RFL[kind]).finish()
    tsch = TBuilder("t").pk("id").add("v", TFT.UINT64,
                                      filter=TFL[kind]).finish()
    return (rsch, r_build(rsch, data, pack_size=PACK),
            tsch, t_build(tsch, data, pack_size=PACK))


def _same_filters(tfs, rfs):
    assert int(tfs.filter_type) == int(rfs.filter_type)
    if rfs.bloom_words is not None:
        np.testing.assert_array_equal(tfs.bloom_words, rfs.bloom_words)
    if rfs.pack_filters is None:
        assert tfs.pack_filters is None
        return
    assert len(tfs.pack_filters) == len(rfs.pack_filters)
    for a, b in zip(tfs.pack_filters, rfs.pack_filters):
        if hasattr(b, "fp"):
            assert a.seed == b.seed
            np.testing.assert_array_equal(a.fp, b.fp)
        else:
            np.testing.assert_array_equal(a.to_array(), b.to_array())


@pytest.mark.parametrize("kind", ["BFUSE8", "BFUSE16", "BITS", "BLOOM_2B"])
def test_pack_filters_built_equal(rng, kind):
    data = _data(rng)
    rsch, rseg, tsch, tseg = _segs(kind, data)
    tfs, rfs = tseg.stats.fields["v"], rseg.stats.fields["v"]
    _same_filters(tfs, rfs)
    _same_filters(segment_from_reference(rseg).stats.fields["v"], rfs)
    # prune decisions on present values, absent in-range values (odd:
    # never generated) and IN sets are the reference's
    probes = [int(data["v"][0]), int(data["v"][PACK + 7]), 1, 100001,
              300001]
    for v in probes:
        kl = lb.to_keyform(np.array([v], np.uint64), TFT.UINT64)
        t = TST.prune_leaf(tfs, TFM.EQ, lo=v, key_limbs=kl)
        r = RST.prune_leaf(rfs, RFM.EQ, lo=v, key_limbs=kl)
        np.testing.assert_array_equal(t.none, r.none)
        np.testing.assert_array_equal(t.all_, r.all_)
        if kind == "BITS" and v % 2:
            assert t.none.all(), f"BITS false positive for {v}"
    ks = np.array(probes, np.uint64)
    kl = lb.to_keyform(ks, TFT.UINT64)
    t = TST.prune_leaf(tfs, TFM.IN, lo=None, keys=ks, key_limbs=kl)
    r = RST.prune_leaf(rfs, RFM.IN, lo=None, keys=ks, key_limbs=kl)
    np.testing.assert_array_equal(t.none, r.none)


@pytest.mark.parametrize("kind", ["BFUSE8", "BFUSE16", "BITS", "BLOOM_2B"])
def test_pruned_scans_equal(rng, kind):
    """Pack-filter-pruned scans: an absent value inside pack 0's zone map
    is pruned by the filter alone; counts, sums and packs matched equal
    the reference's, on the port's own segment and on the reference's."""
    data = _data(rng)
    rsch, rseg, tsch, tseg = _segs(kind, data)
    rsc = RScanner(RDevSeg(rseg))
    tscs = [TScanner(TDevSeg(tseg, "cpu")),
            TScanner(TDevSeg(segment_from_reference(rseg), "cpu"))]
    v0 = int(data["v"][0])
    specs = [("EQ", 1), ("EQ", v0), ("IN", [1, 100001, v0]),
             ("NOT_IN", [v0, 3])]
    for mode, val in specs:
        rt = RQ.leaf(RQ.Filter(rsch.field("v"), RFM[mode], val)).optimize()
        r = rsc.scan(rt, [RAgg("count"), RAgg("sum", "v")])
        tt = TQ.leaf(TQ.Filter(tsch.field("v"), TFM[mode], val)).optimize()
        for tsc in tscs:
            t = tsc.scan(tt, [TAgg("count"), TAgg("sum", "v")])
            assert (t.count, t.aggs) == (r.count, r.aggs)
            assert t.stats["packs_matched"] == r.stats["packs_matched"]
    tt = TQ.leaf(TQ.Filter(tsch.field("v"), TFM.EQ, 1)).optimize()
    assert tscs[0].scan(tt, [TAgg("count")]).count == 0


def test_string_fuse_filter_scan():
    rsch = RBuilder("t").pk("id").add("s", RFT.STRING,
                                      filter="bfuse8").finish()
    tsch = TBuilder("t").pk("id").add("s", TFT.STRING,
                                      filter="bfuse8").finish()
    n = 256
    data = {"id": np.arange(1, n + 1, dtype=np.uint64),
            "s": [f"key-{i:04d}" for i in range(n)]}
    rseg = r_build(rsch, data, pack_size=64)
    tseg = t_build(tsch, data, pack_size=64)
    _same_filters(tseg.stats.fields["s"], rseg.stats.fields["s"])
    rsc = RScanner(RDevSeg(rseg))
    tsc = TScanner(TDevSeg(tseg, "cpu"))
    for v, want in (("key-0007", 1), ("key-zz", 0)):
        r = rsc.scan(RQ.leaf(RQ.Filter(rsch.field("s"), RFM.EQ,
                                       v)).optimize(), [RAgg("count")])
        t = tsc.scan(TQ.leaf(TQ.Filter(tsch.field("s"), TFM.EQ,
                                       v)).optimize(), [TAgg("count")])
        assert t.count == r.count == want
        assert t.stats["packs_matched"] == r.stats["packs_matched"]


def test_strict_filter_kinds():
    sch = TBuilder("t").pk("id").add("s", TFT.STRING,
                                     filter=TFL.BITS).finish()
    with pytest.raises(ValueError, match="BITS"):
        t_build(sch, {"id": np.arange(1, 9, dtype=np.uint64),
                      "s": [f"x{i}" for i in range(8)]}, pack_size=32)
    schw = TBuilder("t").pk("id").add("w", TFT.INT128,
                                      filter=TFL.BITS).finish()
    with pytest.raises(ValueError, match="BITS"):
        t_build(schw, {"id": np.arange(1, 9, dtype=np.uint64),
                       "w": [int(x) << 70 for x in range(8)]}, pack_size=32)
    with pytest.raises(ValueError):
        TBL.bloom_bits(1024, TFL.BITS)
    with pytest.raises(ValueError, match="unknown pack filter"):
        field_meta(filter="blooom")


# ------------------------------------------------------------ stats tree --

def _mk_stats(ST, rng, P, kind):
    base = (np.arange(P) // ST._TREE_BLOCK) * 100_000
    mn = (base + rng.integers(0, 500, P)).astype(np.uint64)
    mx = mn + rng.integers(0, 400, P).astype(np.uint64)
    fs = ST.FieldStats(mn, mx)
    if kind == "BITS":
        # one exact key per pack: its min
        fs.filter_type = ST.FilterType.BITS
        RS = TRS if ST is TST else RRS
        fs.pack_filters = [RS.RidSet.from_array(np.array([k], np.uint64))
                           for k in mn]
    return fs


@pytest.mark.parametrize("kind", ["NONE", "BITS"])
@pytest.mark.parametrize("mode,kw", [
    ("LT", dict(lo=250_000)),
    ("LE", dict(lo=250_000)),
    ("GT", dict(lo=199_700)),
    ("GE", dict(lo=199_700)),
    ("RANGE", dict(lo=150_000, hi=350_100)),
    ("EQ", dict(lo=200_123)),
    ("NE", dict(lo=200_123)),
    ("IN", dict(lo=None, keys=np.array([100_123, 400_001], np.uint64))),
    ("NOT_IN", dict(lo=None, keys=np.array([100_123, 400_001],
                                           np.uint64))),
])
def test_stats_tree_equal(mode, kw, kind):
    """At >= 2 x 2048 packs the two-level tree decides; its tri-states
    equal the reference's, with and without exact BITS filters."""
    P = 3 * TST._TREE_BLOCK + 137
    t = TST.prune_leaf(_mk_stats(TST, np.random.default_rng(1), P, kind),
                       TFM[mode], **kw)
    r = RST.prune_leaf(_mk_stats(RST, np.random.default_rng(1), P, kind),
                       RFM[mode], **kw)
    np.testing.assert_array_equal(t.all_, r.all_)
    np.testing.assert_array_equal(t.none, r.none)
