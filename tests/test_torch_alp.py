"""Float columns end to end: ALP (decimal-scaled) packs and keyform float
packs of knoxdb_tpu_torch against the knoxdb_tpu reference on the very same
packs (segment_from_reference). The host bounds (enc_bounds, frac_bounds,
_alp_keybound), every filter mode, count / sum / avg / min / max, the
projection and top-k must be bit-identical; NaN is compared as NaN, -0.0 by
its bits."""

import math
import struct

import numpy as np
import pytest

from knoxdb_tpu.encode import alp as RA
from knoxdb_tpu.exec import rewrite as RRW
from knoxdb_tpu.exec import sort as RSort
from knoxdb_tpu.exec.device import DeviceSegment as RDevSeg
from knoxdb_tpu.exec.scan import AggSpec as RAgg
from knoxdb_tpu.exec.scan import SegmentScanner as RScanner
from knoxdb_tpu.pack.segment import build_segment as r_build
from knoxdb_tpu.query import filter as RQ
from knoxdb_tpu.schema.schema import Builder as RBuilder
from knoxdb_tpu.types import FieldType as RFT
from knoxdb_tpu.types import FilterMode as RFM
from knoxdb_tpu_torch.encode import alp as TA
from knoxdb_tpu_torch.encode.schemes import Scheme
from knoxdb_tpu_torch.exec import rewrite as TRW
from knoxdb_tpu_torch.exec import sort as TSort
from knoxdb_tpu_torch.exec.device import DeviceSegment as TDevSeg
from knoxdb_tpu_torch.exec.scan import AggSpec as TAgg
from knoxdb_tpu_torch.exec.scan import SegmentScanner as TScanner
from knoxdb_tpu_torch.ops import bitset as TBS
from knoxdb_tpu_torch.ops import words as WD
from knoxdb_tpu_torch.pack.segment import segment_from_reference
from knoxdb_tpu_torch.query import filter as TQ
from knoxdb_tpu_torch.types import FieldType as TFT
from knoxdb_tpu_torch.types import FilterMode as TFM

PACK = 1024
P = 6


def _bits(x) -> int:
    return struct.unpack("<Q", struct.pack("<d", float(x)))[0]


def _same_float(a, b):
    """Bit-identical floats; NaN equals NaN whatever its payload."""
    if a is None or b is None:
        assert a is None and b is None, (a, b)
    elif math.isnan(a) or math.isnan(b):
        assert math.isnan(a) and math.isnan(b), (a, b)
    else:
        assert _bits(a) == _bits(b), (a, b, a - b)


class Eng:
    def __init__(self):
        rng = np.random.default_rng(0xA1B)
        n = PACK * P
        pack = np.arange(n) // PACK
        price = np.round(rng.uniform(0.5, 2500.0, n), 4)
        # packs 2 and 3 sit on another decimal scale and sign
        price = np.where(pack == 2, np.round(rng.uniform(-90, 90, n), 2),
                         price)
        price = np.where(pack == 3, np.round(rng.uniform(-1e6, 1e6, n), 1),
                         price)
        lat = rng.uniform(-90.0, 90.0, n)             # no exponent fits
        mixed = price.copy()                          # ALP and keyform packs
        mixed[pack == 1] = rng.standard_normal(PACK) * 1e3
        mixed[4 * PACK + 5] = math.nan                # pack 4: keyform
        mixed[4 * PACK + 6] = -0.0
        mixed[4 * PACK + 7] = math.inf
        mixed[5 * PACK + 9] = -0.0                    # inside an ALP pack
        f32 = (rng.standard_normal(n) * 100).astype(np.float32)
        f32[11] = -0.0
        self.data = {"id": np.arange(1, n + 1, dtype=np.uint64),
                     "price": price, "lat": lat, "mixed": mixed, "f32": f32,
                     "k": rng.integers(0, 50, n).astype(np.uint32)}
        b = RBuilder("f").pk("id")
        for name, ft in (("price", "FLOAT64"), ("lat", "FLOAT64"),
                         ("mixed", "FLOAT64"), ("f32", "FLOAT32"),
                         ("k", "UINT32")):
            b = b.add(name, RFT[ft])
        self.rsch = b.finish()
        self.rseg = r_build(self.rsch, self.data, pack_size=PACK)
        self.tseg = segment_from_reference(self.rseg)
        self.tsch = self.tseg.schema
        self.rsc = RScanner(RDevSeg(self.rseg))
        self.tsc = TScanner(TDevSeg(self.tseg, "cpu"))
        self.n = n

    def trees(self, spec):
        def build(Q, FM, sch, s):
            if s is None:
                return None
            if s[0] == "leaf":
                return Q.leaf(Q.Filter(sch.field(s[1]), FM[s[2]], s[3]))
            return (Q.and_ if s[0] == "and" else Q.or_)(
                *[build(Q, FM, sch, c) for c in s[1:]])
        r, t = build(RQ, RFM, self.rsch, spec), build(TQ, TFM, self.tsch, spec)
        return (r.optimize(), t.optimize()) if spec is not None else (r, t)

    def masks(self, spec):
        rtree, ttree = self.trees(spec)
        rfn, rargs, _raw = self.rsc.prepare(rtree, [])
        tfn, targs = self.tsc.prepare(ttree, [])
        return (np.asarray(rfn(*rargs)[0]), WD.from_words(tfn(*targs)[0]))


@pytest.fixture(scope="module")
def eng():
    e = Eng()
    sch = {f: [g.scheme for g in e.tsc.d.column(f).groups]
           for f in ("price", "lat", "mixed", "f32")}
    assert set(sch["price"]) == {Scheme.ALP}
    assert len(sch["price"]) >= 2                   # several widths
    assert Scheme.ALP not in sch["lat"] and Scheme.ALP not in sch["f32"]
    assert Scheme.ALP in sch["mixed"] and len(set(sch["mixed"])) >= 2
    return e


# ------------------------------------------------------------- host -----

def _consts():
    rng = np.random.default_rng(5)
    on = [0.0, 1.0, -1.0, 12.5, 1234.5678, -0.01, 1e-4, 99.99, 2500.0]
    between = [math.nextafter(v, math.inf) for v in on] \
        + [math.nextafter(v, -math.inf) for v in on] \
        + list(rng.uniform(-3000, 3000, 20)) \
        + [1e300, -1e300, math.inf, -math.inf, 5e-324, 2.0 ** 51 + 0.5]
    return on + between


@pytest.mark.parametrize("e", [0, 1, 2, 4, 7, 18])
def test_enc_and_frac_bounds_equal_reference(e):
    for c in _consts():
        assert TA.enc_bounds(c, e) == RA.enc_bounds(c, e), (c, e)
        if math.isfinite(c):
            assert TA.frac_bounds(c, e) == RA.frac_bounds(c, e), (c, e)
    # on a representable decimal the three bounds meet
    le, ge, eq = TA.enc_bounds(12.5, 2)
    assert (le, ge, eq) == (1250, 1250, 1250)
    le, ge, eq = TA.enc_bounds(math.nextafter(12.5, 13), 2)
    assert (le, ge, eq) == (1250, 1251, None)
    assert TA.frac_bounds(0.1, 1) == (1, 2, False)   # 0.1 is above 1/10


def test_alp_keybound_equals_reference():
    from knoxdb_tpu.utils import limbs as rlb
    for ft_r, ft_t in ((RFT.FLOAT64, TFT.FLOAT64),):
        for c in _consts() + [math.nan]:
            key = 0
            for limb in rlb.scalar_to_keyform(c, ft_r):
                key = (key << 32) | int(limb)
            for k in (key, max(0, key - 1), min((1 << 64) - 1, key + 1)):
                _same_float(TRW._alp_keybound(k, ft_t),
                            RRW._alp_keybound(k, ft_r))


# ---------------------------------------------------------- filters -----

_MODES = ["EQ", "NE", "LT", "LE", "GT", "GE"]


def _values(eng, field):
    col = eng.data[field]
    present = float(col[3])
    absent = float(np.nextafter(col[3], np.inf))
    return present, absent


@pytest.mark.parametrize("field,mode", [
    *[(f, m) for f in ("price", "mixed") for m in _MODES],
    ("lat", "EQ"), ("lat", "LT"), ("lat", "GE"),
    ("f32", "NE"), ("f32", "LE"), ("f32", "GT")])
def test_compare_modes(eng, field, mode):
    col = eng.data[field]
    for v in _values(eng, field):
        if field == "f32":
            v = float(np.float32(v))
        r, t = eng.masks(("leaf", field, mode, v))
        np.testing.assert_array_equal(t, r)
        want = {"EQ": col == v, "NE": col != v, "LT": col < v,
                "LE": col <= v, "GT": col > v, "GE": col >= v}[mode]
        if not np.isnan(col).any():
            np.testing.assert_array_equal(_unpack(t), want)


def _unpack(words):
    w = np.ascontiguousarray(words.reshape(-1), np.uint32)
    return np.unpackbits(w.view(np.uint8), bitorder="little").astype(bool)


@pytest.mark.parametrize("field", ["price", "mixed", "f32"])
def test_range_in_and_trees(eng, field):
    col = eng.data[field]
    present, absent = _values(eng, field)
    mid = float(np.median(col[np.isfinite(col)]))
    cast = (lambda v: float(np.float32(v))) if field == "f32" else float
    lo, hi = sorted((cast(mid), cast(present)))
    specs = [
        ("leaf", field, "RANGE", (lo, hi)),
        ("leaf", field, "RANGE", (cast(absent), cast(absent))),
        ("leaf", field, "IN", [cast(present), cast(absent), cast(col[77])]),
        ("leaf", field, "NOT_IN", [cast(present), cast(col[78])]),
        # the optimizer merges the strict bounds into one RANGE whose keys
        # step by one ulp: the ALP bound comes back from the keyform
        ("and", ("leaf", field, "GT", lo), ("leaf", field, "LE", hi)),
        ("and", ("leaf", field, "GE", lo), ("leaf", field, "LT", hi),
         ("leaf", "k", "LT", 30)),
        ("or", ("leaf", field, "LT", lo), ("leaf", "k", "EQ", 7)),
    ]
    for spec in specs:
        r, t = eng.masks(spec)
        np.testing.assert_array_equal(t, r, err_msg=str(spec))
    if not np.isnan(col).any():
        _r, t = eng.masks(specs[4])
        np.testing.assert_array_equal(_unpack(t), (col > lo) & (col <= hi))
        _r, t = eng.masks(specs[2])
        np.testing.assert_array_equal(
            _unpack(t), np.isin(col, [cast(present), cast(col[77])]))


def test_infinite_and_huge_bounds(eng):
    for field in ("price", "mixed"):
        for spec in [("leaf", field, "LT", math.inf),
                     ("leaf", field, "GT", -math.inf),
                     ("leaf", field, "GE", 1e300),
                     ("leaf", field, "LE", -1e300),
                     ("leaf", field, "RANGE", (-math.inf, math.inf)),
                     ("leaf", field, "EQ", 1e300)]:
            r, t = eng.masks(spec)
            np.testing.assert_array_equal(t, r, err_msg=str(spec))


# ------------------------------------------------------- aggregates -----

_AGG_SPECS = [None, ("leaf", "k", "LT", 25),
              ("leaf", "price", "RANGE", (100.0, 900.0)),
              ("and", ("leaf", "lat", "GT", -45.0), ("leaf", "k", "NE", 3)),
              ("leaf", "k", "GT", 1000)]         # nothing matches


@pytest.mark.parametrize("field,si", [
    ("price", 0), ("price", 1), ("price", 2), ("price", 4), ("lat", 0),
    ("lat", 3), ("mixed", 0), ("mixed", 2), ("f32", 0), ("f32", 1)])
def test_aggregates(eng, field, si):
    spec = _AGG_SPECS[si]
    rtree, ttree = eng.trees(spec)
    ops = ["count", "sum", "avg", "min", "max"]
    want = eng.rsc.scan(rtree, [RAgg(o, "" if o == "count" else field)
                                for o in ops])
    got = eng.tsc.scan(ttree, [TAgg(o, "" if o == "count" else field)
                               for o in ops])
    assert got.count == want.count
    for o in ops[1:]:
        _same_float(got.aggs[(o, field)], want.aggs[(o, field)])
    # an oracle for the exact ALP column: the rational sum, divided once
    if field == "price" and spec != _AGG_SPECS[3]:
        from fractions import Fraction
        col = eng.data["price"]
        k = eng.data["k"]
        m = {0: np.ones(eng.n, bool), 1: k < 25,
             2: (col >= 100.0) & (col <= 900.0),
             4: np.zeros(eng.n, bool)}[_AGG_SPECS.index(spec)]
        assert got.count == int(m.sum())
        exact = sum((Fraction(str(v)) for v in col[m]), Fraction(0))
        assert got.aggs[("sum", "price")] == float(exact)
        if m.any():
            assert got.aggs[("min", "price")] == float(col[m].min())
            assert got.aggs[("max", "price")] == float(col[m].max())


def test_exclude_words_and_float_sum_order(eng):
    """The keyform float sum is the reference's log-depth pairwise order:
    bit-identical under any mask, and different from a left-to-right sum
    somewhere (else the order would not be under test)."""
    rng = np.random.default_rng(8)
    rows = rng.random(eng.n) < 0.4
    excl = TBS.np_pack_mask(rows).reshape(P, -1)
    want = eng.rsc.scan(None, [RAgg("sum", "lat"), RAgg("sum", "f32")],
                        exclude_words=excl)
    got = eng.tsc.scan(None, [TAgg("sum", "lat"), TAgg("sum", "f32")],
                       exclude_words=excl)
    for k in (("sum", "lat"), ("sum", "f32")):
        _same_float(got.aggs[k], want.aggs[k])
    seq = 0.0
    for v in eng.data["lat"][~rows]:
        seq += v
    assert abs(got.aggs[("sum", "lat")] - seq) <= 1e-9 * eng.n
    assert got.count == int((~rows).sum())


# ------------------------------------------- projection and top-k -------

@pytest.mark.parametrize("spec", [None, ("leaf", "price", "LT", 300.0),
                                  ("leaf", "mixed", "GE", 0.0)])
def test_projection(eng, spec):
    rtree, ttree = eng.trees(spec)
    proj = ["price", "lat", "mixed", "f32", "id"]
    want = eng.rsc.scan(rtree, [], project=proj)
    got = eng.tsc.scan(ttree, [], project=proj)
    np.testing.assert_array_equal(got.row_ids, want.row_ids)
    for f in proj:
        a, b = got.rows[f], np.asarray(want.rows[f])
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(
            a.view(np.uint64 if a.dtype == np.float64 else
                   np.uint32 if a.dtype == np.float32 else a.dtype),
            b.view(np.uint64 if b.dtype == np.float64 else
                   np.uint32 if b.dtype == np.float32 else b.dtype), f)
        src = eng.data[f][got.row_ids.astype(np.int64)]
        np.testing.assert_array_equal(a, src)       # NaN equals NaN here


def test_scan_stream_floats(eng):
    _rtree, ttree = eng.trees(("leaf", "price", "GT", 2000.0))
    rows = [r for r in eng.tsc.scan_stream(ttree, ["price", "mixed"],
                                           batch_packs=2)]
    ids = np.concatenate([r.row_ids for r in rows]).astype(np.int64)
    want = np.flatnonzero(eng.data["price"] > 2000.0)
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_array_equal(
        np.concatenate([r.rows["price"] for r in rows]),
        eng.data["price"][want])
    np.testing.assert_array_equal(
        np.concatenate([r.rows["mixed"] for r in rows]),
        eng.data["mixed"][want])


@pytest.mark.parametrize("field,desc", [("f32", True)])
def test_topk_by_keyform_float(eng, field, desc):
    """Ordered top-k by a float column whose packs are all keyform: the
    keyform order is the float order."""
    rtree, ttree = eng.trees(("leaf", "k", "LT", 40))
    wk, wrows, wn = RSort.segment_topk(eng.rsc, rtree, field, 25, desc,
                                       project=["id"])
    gk, grows, gn = TSort.segment_topk(eng.tsc, ttree, field, 25, desc,
                                       project=["id"])
    assert gn == wn and [int(k) for k in gk] == [int(k) for k in wk]
    np.testing.assert_array_equal(grows["__idx"][:gn],
                                  np.asarray(wrows["__idx"])[:wn])
    col = eng.data[field].astype(np.float64)
    m = eng.data["k"] < 40
    order = np.argsort(-col[m] if desc else col[m], kind="stable")[:25]
    np.testing.assert_array_equal(np.sort(grows["__idx"][:gn]),
                                  np.sort(np.flatnonzero(m)[order]))


@pytest.mark.parametrize("desc", [False, True])
def test_topk_by_alp_column(eng, desc):
    """Top-k by a column with ALP packs of different bases and exponents:
    the port orders by the decoded values' float keyform and equals numpy.
    The reference sorts the packs' relative enc, which do not compare
    across packs, and differs here (a fault of the reference, ROADMAP.md
    section 3)."""
    from knoxdb_tpu_torch.utils import limbs as TL
    col = eng.data["price"]
    _rtree, ttree = eng.trees(("leaf", "k", "LT", 40))
    gk, grows, gn = TSort.segment_topk(eng.tsc, ttree, "price", 25, desc)
    m = eng.data["k"] < 40
    cand = np.flatnonzero(m)
    order = cand[np.argsort(-col[m] if desc else col[m], kind="stable")[:25]]
    assert gn == 25
    np.testing.assert_array_equal(grows["__idx"][:gn], order)
    assert [int(k) for k in gk] == [
        int(k) for k in TL.to_keys64(col[order], TFT.FLOAT64)]
    _wk, wrows, _wn = RSort.segment_topk(eng.rsc, _rtree, "price", 25, desc)
    assert not np.array_equal(np.asarray(wrows["__idx"])[:25], order)


def test_float32_series_moments(eng):
    """Moments of a FLOAT32 field: the port widens the decoded float32 to
    float64 and is held to numpy; the reference reads the 32-bit keyform as
    a 64-bit one and returns NaN (a fault of the reference, ROADMAP.md
    section 3)."""
    from knoxdb_tpu.exec import groupby as RGB
    from knoxdb_tpu_torch.exec import groupby as TGB
    G, iv = 8, 16
    k = eng.data["k"].astype(np.int64)
    tplan = TGB.plan_buckets(eng.tsc.d, "k", 0, iv, G)
    n_, s1, s2 = eng.tsc.series_scan(None, "k", {"f32": ("moments",)},
                                     tplan)[("f32", "moments")]
    v = eng.data["f32"].astype(np.float64)
    b = k // iv
    ok = b < G
    np.testing.assert_array_equal(n_, np.bincount(b[ok], minlength=G))
    for got, x in ((s1, v), (s2, v * v)):
        exact = np.array([math.fsum(x[ok & (b == i)]) for i in range(G)])
        scale = np.array([np.abs(x[ok & (b == i)]).sum() for i in range(G)])
        assert (np.abs(got - exact) <= 64 * 2.0 ** -52 * scale).all()
    rplan = RGB.plan_buckets(eng.rsc.d, "k", 0, iv, G)
    ref = eng.rsc.series_scan(None, "k", {"f32": ("moments",)}, rplan)
    assert np.isnan(np.asarray(ref[("f32", "moments")][1])).any()


# ------------------------------------------------ NaN, -0.0, FLOAT32 ----

def test_nan_and_negative_zero(eng):
    """NaN sorts above +inf and -0.0 shares +0.0's key in the keyform
    (utils/limbs.to_keyform); the device conversions agree with the host
    everywhere but on a -0.0 that no stored pack can hold."""
    import torch

    from knoxdb_tpu_torch.exec import device as TD
    from knoxdb_tpu_torch.exec import groupby as TGB
    from knoxdb_tpu_torch.utils import limbs as TL
    vals = np.array([math.nan, -math.nan, -0.0, 0.0, math.inf, -math.inf,
                     5e-324, -5e-324, 1.5, -1.5], np.float64)
    keys = TL.to_keys64(vals, TFT.FLOAT64)
    t = torch.from_numpy(vals.copy())
    got = TGB.f64_to_keyform(t).numpy().view(np.uint64)
    # the host maps -0.0 onto +0.0's key (so that x < 0.0 leaves -0.0 out,
    # as IEEE compares do); the device map, like the reference's, is the
    # plain bit map and puts -0.0 one key below. It only ever sees ALP
    # decodes, which cannot give -0.0.
    assert got[2] == keys[2] - 1 == (1 << 63) - 1
    np.testing.assert_array_equal(np.delete(got, 2), np.delete(keys, 2))
    vals[2] = 0.0                       # the host's -0.0 is +0.0
    lo, hi = WD.split_u64(keys)
    back2 = TD.keyform_to_float(WD.to_words(lo, "cpu"),
                                WD.to_words(hi, "cpu"), TFT.FLOAT64)
    np.testing.assert_array_equal(back2.numpy().view(np.uint64),
                                  vals.view(np.uint64))
    v32 = np.array([math.nan, -0.0, 0.0, 3.25, -7.5, math.inf], np.float32)
    k32 = TL.to_keys64(v32, TFT.FLOAT32)
    lo, hi = WD.split_u64(k32)
    back3 = TD.keyform_to_float(WD.to_words(lo, "cpu"),
                                WD.to_words(hi, "cpu"), TFT.FLOAT32)
    v32[1] = 0.0                        # the host's -0.0 is +0.0
    np.testing.assert_array_equal(back3.numpy().view(np.uint32),
                                  v32.view(np.uint32))
    # -0.0 = 0.0 and NaN above +inf, in keyform order
    assert keys[2] == keys[3] and keys[0] > keys[4]
    # in the segment: EQ 0.0 does not match -0.0, and min over the pack
    # that holds -0.0 and NaN follows the keyform
    r, t_ = eng.masks(("leaf", "mixed", "EQ", 0.0))
    np.testing.assert_array_equal(t_, r)
    rtree, ttree = eng.trees(("leaf", "mixed", "RANGE", (-0.0, math.inf)))
    want = eng.rsc.scan(rtree, [RAgg("min", "mixed"), RAgg("max", "mixed"),
                                RAgg("sum", "mixed")])
    got = eng.tsc.scan(ttree, [TAgg("min", "mixed"), TAgg("max", "mixed"),
                               TAgg("sum", "mixed")])
    assert got.count == want.count
    for k in want.aggs:
        _same_float(got.aggs[k], want.aggs[k])


def test_pairwise_sum_order():
    import torch

    from knoxdb_tpu_torch.exec import device as TD
    rng = np.random.default_rng(1)
    v = rng.standard_normal((3, 1024)) * 10.0 ** rng.integers(-8, 8, (3, 1024))
    got = TD.pairwise_sum(torch.from_numpy(v)).numpy()
    x = v.copy()
    n = x.shape[-1]
    while n > 1:
        n //= 2
        x = x[..., :n] + x[..., n:2 * n]
    np.testing.assert_array_equal(got, x[..., 0])
