"""The group-by and series slice end to end: knoxdb_tpu_torch
SegmentScanner.group_scan / series_scan against the knoxdb_tpu reference
on the very same packs (segment_from_reference), and both against a numpy
oracle. Counts, exact sums, extremes and moments must be equal, and each
call must have taken the port's group kernel route (the plain version's
call counter rises on the CPU) or, with minmax, group_aggregate."""

import numpy as np
import pytest

from knoxdb_tpu.exec import groupby as RGB
from knoxdb_tpu.exec.device import DeviceSegment as RDevSeg
from knoxdb_tpu.exec.scan import SegmentScanner as RScanner
from knoxdb_tpu.pack.segment import build_segment as r_build
from knoxdb_tpu.query import filter as RQ
from knoxdb_tpu.schema.schema import Builder as RBuilder
from knoxdb_tpu.types import FieldType as RFT
from knoxdb_tpu.types import FilterMode as RFM
from knoxdb_tpu_torch.exec import groupby as TGB
from knoxdb_tpu_torch.exec.device import DeviceSegment as TDevSeg
from knoxdb_tpu_torch.exec.scan import SegmentScanner as TScanner
from knoxdb_tpu_torch.ops import bitset as TBS
from knoxdb_tpu_torch.ops import group_kernels as GK
from knoxdb_tpu_torch.pack.segment import segment_from_reference
from knoxdb_tpu_torch.query import filter as TQ
from knoxdb_tpu_torch.types import FilterMode as TFM
from knoxdb_tpu_torch.utils import limbs as TL

PACK = 2048
U64_MAX = (1 << 64) - 1


def _tree(Q, FM, sch, spec):
    """("leaf", field, mode, value) or ("and"|"or", child, ...) -> one
    package's optimized filter tree; None stays None."""
    if spec is None:
        return None

    def build(s):
        if s[0] == "leaf":
            return Q.leaf(Q.Filter(sch.field(s[1]), FM[s[2]], s[3]))
        kids = [build(c) for c in s[1:]]
        return (Q.and_ if s[0] == "and" else Q.or_)(*kids)
    return build(spec).optimize()


class Engines:
    """One reference segment, scanned by both engines."""

    def __init__(self, cols, data, pack=PACK):
        b = RBuilder("t").pk("id")
        for name, ft, kw in cols:
            b = b.add(name, RFT[ft], **kw)
        self.rsch = b.finish()
        self.data = data
        self.rseg = r_build(self.rsch, data, pack_size=pack)
        self.tseg = segment_from_reference(self.rseg)
        self.rsc = RScanner(RDevSeg(self.rseg))
        self.tsc = TScanner(TDevSeg(self.tseg, "cpu"))

    def trees(self, spec):
        return (_tree(RQ, RFM, self.rsch, spec),
                _tree(TQ, TFM, self.tseg.schema, spec))

    def group(self, spec, gf, aggs, minmax, **kw):
        rtree, ttree = self.trees(spec)
        rplan, rc, rres = self.rsc.group_scan(rtree, gf, aggs,
                                              minmax=minmax, **kw)
        before = GK.PLAIN_CALLS["fused_group_partials"]
        tplan, tc, tres = self.tsc.group_scan(ttree, gf, aggs,
                                              minmax=minmax, **kw)
        ran = GK.PLAIN_CALLS["fused_group_partials"] - before
        assert ran == (0 if minmax else len(aggs or [gf]))
        assert list(tplan.keys) == list(rplan.keys)
        np.testing.assert_array_equal(tc, np.asarray(rc))
        assert tc.dtype == np.int64
        assert tres.keys() == rres.keys()
        for f in tres:
            assert list(tres[f][0]) == list(rres[f][0]), f
            np.testing.assert_array_equal(tres[f][1], np.asarray(rres[f][1]))
            np.testing.assert_array_equal(tres[f][2], np.asarray(rres[f][2]))
            assert tres[f][1].dtype == tres[f][2].dtype == np.uint64
        return tplan, tc, tres


def _keyform(v, ft):
    """Keyform u64 of each value as python ints; strings aggregate as 0
    (a bytes dictionary has no integer values)."""
    if ft.is_bytes_like:
        return np.zeros(len(v), object)
    return TL.to_keys64(v, ft).astype(object)


def _check_oracle(eng, gf, aggs, m, out, minmax):
    """Per group: count, keyform sum, min and max over rows m."""
    gplan, counts, res = out
    d = eng.data
    ftk = eng.tseg.schema.field(gf).type
    kv = list(gplan.key_values(ftk))
    index = {k: i for i, k in enumerate(kv)}
    gid = np.array([index[k] for k in d[gf]])
    G = gplan.G
    np.testing.assert_array_equal(counts, np.bincount(gid[m], minlength=G))
    for f in aggs or [gf]:
        keys = _keyform(d[f], eng.tseg.schema.field(f).type)
        sums = np.zeros(G, object)
        np.add.at(sums, gid[m], keys[m])
        assert list(res[f][0]) == list(sums)
        mn = np.full(G, U64_MAX, object)
        mx = np.zeros(G, object)
        if minmax:
            for g, k in zip(gid[m], keys[m]):
                mn[g] = min(mn[g], k)
                mx[g] = max(mx[g], k)
        assert [int(x) for x in res[f][1]] == list(mn)
        assert [int(x) for x in res[f][2]] == list(mx)


_THR = -((1 << 40) * 49) // 50      # config #3's 99%-pass filter


@pytest.fixture(scope="module")
def cfg3():
    """BASELINE config #3's schema (bench_suite.py:171-198), small."""
    rng = np.random.default_rng(0xC0FFEE)
    n, G = PACK * 8, 1000
    data = {"id": np.arange(1, n + 1, dtype=np.uint64),
            "acct": rng.integers(0, G, n, dtype=np.uint64),
            "bal": rng.integers(-1 << 40, 1 << 40, n, dtype=np.int64)}
    return Engines([("acct", "UINT64", {}),
                    ("bal", "DECIMAL64", {"scale": 4})], data)


@pytest.mark.parametrize("minmax", [False, True])
@pytest.mark.parametrize("spec", [None, ("leaf", "bal", "GT", _THR),
                                  ("and", ("leaf", "bal", "GT", 0),
                                   ("leaf", "acct", "LT", 600))])
def test_config3_group_scan(cfg3, spec, minmax):
    d = cfg3.data
    out = cfg3.group(spec, "acct", ["bal"], minmax)
    assert out[0].mode[0][0] == "range" and out[0].G == 1000
    m = np.ones(len(d["bal"]), bool)
    if spec is not None and spec[0] == "leaf":
        m = d["bal"] > _THR
    elif spec is not None:
        m = (d["bal"] > 0) & (d["acct"] < 600)
    _check_oracle(cfg3, "acct", ["bal"], m, out, minmax)


@pytest.mark.parametrize("minmax", [False, True])
def test_exclude_words_and_global_keys(cfg3, minmax):
    d = cfg3.data
    n = len(d["bal"])
    excl_rows = np.random.default_rng(4).random(n) < 0.3
    excl = TBS.np_pack_mask(excl_rows).reshape(n // PACK, -1)
    out = cfg3.group(("leaf", "bal", "GT", _THR), "acct", ["bal", "acct"],
                     minmax, exclude_words=excl)
    _check_oracle(cfg3, "acct", ["bal", "acct"], (d["bal"] > _THR)
                  & ~excl_rows, out, minmax)
    # a wider imposed domain (the union over several segments): sparse,
    # so the group ids come from a search
    gk = np.unique(np.concatenate([np.arange(0, 1000, dtype=np.uint64),
                                   np.array([5000, 7000], np.uint64)]))
    out = cfg3.group(None, "acct", ["bal"], minmax, global_keys=gk)
    assert out[0].mode[0][0] == "search" and out[0].G == len(gk)
    _check_oracle(cfg3, "acct", ["bal"], np.ones(n, bool), out, minmax)
    assert out[1][-2:].tolist() == [0, 0]


@pytest.fixture(scope="module")
def keyed():
    rng = np.random.default_rng(9)
    n = PACK * 6
    sv = np.array(["ant", "bee", "cat", "dog", "emu", "fox", "gnu"], object)
    data = {"id": np.arange(1, n + 1, dtype=np.uint64),
            "k": np.array([10, 20, 30, 40, 5_000_000_000],
                          np.uint64)[rng.integers(0, 5, n)],
            "s": sv[rng.integers(0, 7, n)],
            "v": rng.integers(-1 << 50, 1 << 50, n, dtype=np.int64),
            "w": rng.integers(0, 1 << 20, n, dtype=np.uint32),
            "big": rng.integers(0, 9000, n, dtype=np.uint32)}
    return Engines([("k", "UINT64", {}), ("s", "STRING", {}),
                    ("v", "INT64", {}), ("w", "UINT32", {}),
                    ("big", "UINT32", {})], data)


@pytest.mark.parametrize("minmax", [False, True])
@pytest.mark.parametrize("gf", ["k", "s"])
def test_dict_and_string_keys(keyed, gf, minmax):
    d = keyed.data
    out = keyed.group(("leaf", "w", "LT", 700_000), gf, ["v", "w"], minmax)
    assert {m[0] for m in out[0].mode} == {"lut"}
    _check_oracle(keyed, gf, ["v", "w"], d["w"] < 700_000, out, minmax)
    # count only: the key aggregates itself
    out = keyed.group(None, gf, [], minmax)
    _check_oracle(keyed, gf, [], np.ones(len(d["w"]), bool), out, minmax)


@pytest.mark.parametrize("minmax", [False, True])
def test_big_g(keyed, minmax):
    """G > 8192: the reference runs its multi-pass kernel (or its sort);
    the port's kernel takes the global-atomics route on the card."""
    d = keyed.data
    out = keyed.group(("leaf", "v", "GT", 0), "big", ["w"], minmax)
    assert out[0].G > 8192
    _check_oracle(keyed, "big", ["w"], d["v"] > 0, out, minmax)


def test_group_plan_cache_no_tree_collision():
    """As tests/test_groupby.py::test_group_plan_cache_no_tree_collision:
    group queries with different filter trees but the same group field,
    agg fields and G must not share a plan, so the group plans key on the
    mask plan's whole signature."""
    rng = np.random.default_rng(0xC0FFEE)
    n = 8192
    g = rng.integers(0, 16, n).astype(np.uint32)
    v = rng.integers(-1 << 30, 1 << 30, n)
    eng = Engines([("g", "UINT32", {}), ("v", "INT64", {})],
                  {"id": np.arange(1, n + 1, dtype=np.uint64), "g": g,
                   "v": v}, pack=1024)
    specs = [(None, np.ones(n, bool)),
             (("leaf", "v", "GT", 0), v > 0),
             (("and", ("leaf", "v", "GT", 0), ("leaf", "g", "LT", 9)),
              (v > 0) & (g < 9))]
    for spec, m in specs:
        _plan, counts, res = eng.group(spec, "g", ["v"], False)
        np.testing.assert_array_equal(
            counts, np.bincount(g[m].astype(np.int64), minlength=16))
        wsum = np.zeros(16, object)
        np.add.at(wsum, g[m].astype(np.int64), v[m].astype(object))
        assert [int(s) - int(c) * (1 << 63)
                for s, c in zip(res["v"][0], counts)] == list(wsum)
    groups = [s for s in eng.tsc._fns if s[0] == "group"]
    assert len(groups) == 3
    assert len({s[-1] for s in groups}) == 3


# ------------------------------------------------------------- series ----

@pytest.fixture(scope="module")
def cfg6():
    """BASELINE config #6's schema (bench_suite.py:438-455), small."""
    rng = np.random.default_rng(0xC0FFEE)
    n, t0, span = PACK * 8, 1_000_000, 1024 * 100
    data = {"id": np.arange(1, n + 1, dtype=np.uint64),
            "ts": (t0 - 300 + rng.integers(0, span + 600, n))
            .astype(np.uint64),
            "val": rng.integers(-1 << 30, 1 << 30, n)}
    return Engines([("ts", "UINT64", {}), ("val", "INT64", {})], data)


@pytest.mark.parametrize("spec", [None, ("leaf", "val", "GT", -(1 << 29))])
@pytest.mark.parametrize("G,iv", [(64, 64), (1024, 64), (64, 100),
                                  (1024, 100)])
def test_series_moments(cfg6, G, iv, spec):
    d = cfg6.data
    t0 = 1_000_000
    rplan = RGB.plan_buckets(cfg6.rsc.d, "ts", t0, iv, G)
    tplan = TGB.plan_buckets(cfg6.tsc.d, "ts", t0, iv, G)
    rtree, ttree = cfg6.trees(spec)
    want = cfg6.rsc.series_scan(rtree, "ts", {"val": ("moments",)}, rplan)
    before = GK.PLAIN_CALLS["fused_group_moments_partials"]
    got = cfg6.tsc.series_scan(ttree, "ts", {"val": ("moments",)}, tplan)
    assert GK.PLAIN_CALLS["fused_group_moments_partials"] == before + 1
    assert got.keys() == want.keys() == {("val", "moments")}
    for a, b in zip(got[("val", "moments")], want[("val", "moments")]):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    # numpy oracle: exact python ints cast to f64 once
    ts, val = d["ts"], d["val"]
    m = (ts >= t0) & (ts < t0 + G * iv)
    if spec is not None:
        m &= val > -(1 << 29)
    b = ((ts[m] - np.uint64(t0)) // np.uint64(iv)).astype(np.int64)
    s1 = np.zeros(G, object)
    s2 = np.zeros(G, object)
    np.add.at(s1, b, val[m].astype(object))
    np.add.at(s2, b, val[m].astype(object) ** 2)
    n_, sm, sq = got[("val", "moments")]
    np.testing.assert_array_equal(n_, np.bincount(b, minlength=G))
    np.testing.assert_array_equal(sm, s1.astype(np.float64))
    np.testing.assert_array_equal(sq, s2.astype(np.float64))


def test_series_unported_kinds_raise(cfg6):
    tplan = TGB.plan_buckets(cfg6.tsc.d, "ts", 1_000_000, 64, 64)
    for kinds in ({"val": ("firstlast",)}, {"val": ("moments", "tsruns")},
                  {"val": ("fminmax",)}):
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            cfg6.tsc.series_scan(None, "ts", kinds, tplan)
    rng = np.random.default_rng(2)
    n = 1024
    eng = Engines([("ts", "UINT64", {}), ("f", "FLOAT64", {}),
                   ("u", "UINT64", {})],
                  {"id": np.arange(1, n + 1, dtype=np.uint64),
                   "ts": rng.integers(0, 4096, n, dtype=np.uint64),
                   "f": rng.random(n),
                   "u": rng.integers(0, 1 << 63, n, dtype=np.uint64)},
                  pack=1024)
    tplan = TGB.plan_buckets(eng.tsc.d, "ts", 0, 64, 64)
    # float moments, and moments of values spanning more than 32 bits
    # (the reference's sort route)
    for f in ("f", "u"):
        with pytest.raises(NotImplementedError, match="queue 1 item 7"):
            eng.tsc.series_scan(None, "ts", {f: ("moments",)}, tplan)
