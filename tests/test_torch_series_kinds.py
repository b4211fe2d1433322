"""Every series kind of knoxdb_tpu_torch SegmentScanner.series_scan
(moments, firstlast, tsruns, fminmax) against the knoxdb_tpu reference on
the very same packs, on integer, ALP and keyform float fields, with ties in
ts, empty buckets, a where tree and exclude_words.

Exact outputs (counts, first / last, run boundaries and limb sums, interior
min / max, float min / max) must be bit-identical. Float sums are IEEE
additions in an order each engine picks for itself, so they are held to
|Σ_port - Σ_ref| <= 64 * eps * Σ|v| per bucket (eps = 2^-52), the same for
Σv² against Σv², and the port also to an exactly rounded oracle
(math.fsum) under the same bound. The ts-run sums of the reference come
from one prefix sum over the whole segment, so there the parity bound
scales with the segment's total and the per-bucket bound holds the port
against the oracle."""

import math

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
from knoxdb_tpu_torch.encode.schemes import Scheme
from knoxdb_tpu_torch.exec import groupby as TGB
from knoxdb_tpu_torch.exec.device import DeviceSegment as TDevSeg
from knoxdb_tpu_torch.exec.scan import SegmentScanner as TScanner
from knoxdb_tpu_torch.ops import bitset as TBS
from knoxdb_tpu_torch.pack.segment import segment_from_reference
from knoxdb_tpu_torch.query import filter as TQ
from knoxdb_tpu_torch.types import FilterMode as TFM

PACK = 1024
P = 6
T0 = 5000
EPS = 2.0 ** -52
TOL = 64 * EPS


class Eng:
    def __init__(self):
        rng = np.random.default_rng(0x5E71E5)
        n = PACK * P
        self.n = n
        self.data = {
            "id": np.arange(1, n + 1, dtype=np.uint64),
            # few distinct timestamps: ties inside and across packs
            "ts": (T0 - 40 + rng.integers(0, 700, n)).astype(np.uint64),
            "val": rng.integers(-1 << 30, 1 << 30, n),
            "wide": rng.integers(-1 << 50, 1 << 50, n),
            # four decimals: every pack is ALP
            "price": np.round(rng.uniform(-500.0, 500.0, n), 4),
            # full-precision doubles: no decimal exponent round-trips
            "lat": rng.standard_normal(n) * 90.0,
        }
        b = RBuilder("s").pk("id")
        for name, ft in (("ts", "UINT64"), ("val", "INT64"),
                         ("wide", "INT64"), ("price", "FLOAT64"),
                         ("lat", "FLOAT64")):
            b = b.add(name, RFT[ft])
        self.rsch = b.finish()
        self.rseg = r_build(self.rsch, self.data, pack_size=PACK)
        self.tseg = segment_from_reference(self.rseg)
        self.rsc = RScanner(RDevSeg(self.rseg))
        self.tsc = TScanner(TDevSeg(self.tseg, "cpu"))
        excl_rows = rng.random(n) < 0.2
        self.excl_rows = excl_rows
        self.excl = TBS.np_pack_mask(excl_rows).reshape(P, -1)

    def tree(self, Q, FM, sch):
        return Q.and_(
            Q.leaf(Q.Filter(sch.field("val"), FM.GT, -(1 << 29))),
            Q.leaf(Q.Filter(sch.field("price"), FM.LT, 400.0))).optimize()

    def run(self, kinds, G, iv, where, excl):
        rplan = RGB.plan_buckets(self.rsc.d, "ts", T0, iv, G)
        tplan = TGB.plan_buckets(self.tsc.d, "ts", T0, iv, G)
        rtree = self.tree(RQ, RFM, self.rsch) if where else None
        ttree = self.tree(TQ, TFM, self.tseg.schema) if where else None
        ex = self.excl if excl else None
        want = self.rsc.series_scan(rtree, "ts", kinds, rplan,
                                    exclude_words=ex)
        got = self.tsc.series_scan(ttree, "ts", kinds, tplan,
                                   exclude_words=ex)
        assert got.keys() == want.keys()
        return got, want

    def rows(self, G, iv, where, excl):
        """bool[n] of the rows in range and selected; their bucket ids."""
        d = self.data
        ts = d["ts"].astype(np.int64)
        m = (ts >= T0) & (ts < T0 + G * iv)
        if where:
            m &= (d["val"] > -(1 << 29)) & (d["price"] < 400.0)
        if excl:
            m &= ~self.excl_rows
        return m, (ts - T0) // iv


@pytest.fixture(scope="module")
def eng():
    e = Eng()
    sch = {f: {g.scheme for g in e.tsc.d.column(f).groups}
           for f in ("price", "lat")}
    assert sch["price"] == {Scheme.ALP}
    assert Scheme.ALP not in sch["lat"]
    return e


def _same(a, b):
    b = np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _close(got, want, scale):
    """|got - want| <= 64 eps * scale per bucket."""
    err = np.abs(got - np.asarray(want))
    assert (err <= TOL * scale).all(), (err.max(), (TOL * scale).min())


# G = 96 buckets of 8 leaves buckets empty at the end of the range; the
# others leave timestamps past the last bucket
CASES = [(96, 8, True, False), (24, 30, True, True), (8, 100, False, True)]


@pytest.mark.parametrize("G,iv,where,excl", CASES)
@pytest.mark.parametrize("field", ["val", "wide", "price", "lat"])
def test_moments(eng, field, G, iv, where, excl):
    got, want = eng.run({field: ("moments",)}, G, iv, where, excl)
    g, w = got[(field, "moments")], want[(field, "moments")]
    _same(g[0], w[0])
    m, b = eng.rows(G, iv, where, excl)
    v = eng.data[field][m].astype(np.float64)
    bm = b[m]
    sabs = np.zeros(G)
    np.add.at(sabs, bm, np.abs(v))
    sq = np.zeros(G)
    np.add.at(sq, bm, v * v)
    np.testing.assert_array_equal(g[0], np.bincount(bm, minlength=G))
    if field == "val":          # the exact route: python ints cast once
        _same(g[1], w[1])
        _same(g[2], w[2])
        return
    _close(g[1], w[1], sabs)
    _close(g[2], w[2], sq)
    exact1 = np.array([math.fsum(v[bm == i]) for i in range(G)])
    exact2 = np.array([math.fsum(v[bm == i] ** 2) for i in range(G)])
    _close(g[1], exact1, sabs)
    _close(g[2], exact2, sq)


@pytest.mark.parametrize("G,iv,where,excl", CASES)
@pytest.mark.parametrize("field", ["val", "wide", "price", "lat"])
def test_firstlast(eng, field, G, iv, where, excl):
    got, want = eng.run({field: ("firstlast",)}, G, iv, where, excl)
    g, w = got[(field, "firstlast")], want[(field, "firstlast")]
    for a, b in zip(g, w):
        _same(a, b)
    # oracle: smallest ts, ties to the earliest row; largest ts, ties to
    # the latest row; float payloads are the raw float64 bits
    m, b = eng.rows(G, iv, where, excl)
    ts = eng.data["ts"]
    col = eng.data[field]
    if col.dtype == np.float64:
        pay = col.view(np.uint64)
    else:
        pay = col.astype(np.int64).view(np.uint64) ^ np.uint64(1 << 63)
    for i in range(G):
        r = np.flatnonzero(m & (b == i))
        if not len(r):
            assert (int(g[0][i]), int(g[1][i]), int(g[2][i]),
                    int(g[3][i])) == ((1 << 64) - 1, 0, 0, 0)
            continue
        first = r[np.argmin(ts[r])]                   # first of the minima
        last = r[len(r) - 1 - np.argmax(ts[r][::-1])]  # last of the maxima
        assert (int(g[0][i]), int(g[1][i])) == (int(ts[first]),
                                                int(pay[first]))
        assert (int(g[2][i]), int(g[3][i])) == (int(ts[last]),
                                                int(pay[last]))
        assert int(g[4][i]) == len(r)


_EXACT_RUNS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11)


@pytest.mark.parametrize("G,iv,where,excl", CASES)
@pytest.mark.parametrize("field", ["val", "wide", "price", "lat"])
def test_tsruns(eng, field, G, iv, where, excl):
    got, want = eng.run({field: ("tsruns",)}, G, iv, where, excl)
    g, w = got[(field, "tsruns")], want[(field, "tsruns")]
    assert len(g) == len(w) == 14
    for i in _EXACT_RUNS:
        _same(g[i], w[i])
    # int_sum, int_sumsq: float64 sums over the interior runs' sums
    wsum, wsq = np.asarray(w[12]), np.asarray(w[13])
    assert g[12].dtype == g[13].dtype == np.float64
    # the reference takes both as differences of ONE prefix sum over all
    # the segment's runs, so its own rounding scales with the segment's
    # total, not the bucket's: the parity bound is 64 eps times the total
    # (the port is held per bucket in test_tsruns_integer_oracle)
    n_int = g[11].astype(np.float64)
    tot_abs = np.sqrt(n_int.sum() * wsq.sum())         # >= Σ|s| (Cauchy)
    assert (np.abs(g[12] - wsum) <= TOL * tot_abs).all()
    assert (np.abs(g[13] - wsq) <= TOL * wsq.sum()).all()


def test_tsruns_integer_oracle(eng):
    """The integer field's runs against plain python: rows of one bucket
    grouped by ts, each run summed exactly."""
    G, iv = 24, 30
    got, _ = eng.run({"val": ("tsruns",)}, G, iv, True, True)
    r = got[("val", "tsruns")]
    m, b = eng.rows(G, iv, True, True)
    ts, val = eng.data["ts"], eng.data["val"]
    for i in range(G):
        sel = m & (b == i)
        uts = np.unique(ts[sel])
        assert int(r[0][i]) == len(uts)
        if not len(uts):
            continue
        sums = [int(val[sel & (ts == t)].astype(object).sum()) for t in uts]
        cnts = [int((sel & (ts == t)).sum()) for t in uts]
        for k, (t_, c_, lo_, hi_) in ((0, r[1:5]), (-1, r[5:9])):
            assert int(t_[i]) == int(uts[k]) and int(c_[i]) == cnts[k]
            assert (int(lo_[i]) + (int(hi_[i]) << 32)) % (1 << 64) \
                == sums[k] % (1 << 64)
        inner = sums[1:-1]
        assert int(r[11][i]) == len(inner)
        if inner:
            bias = 1 << 63
            assert int(r[9][i]) == min(inner) + bias
            assert int(r[10][i]) == max(inner) + bias
            assert r[12][i] == float(sum(inner))
            sq = math.fsum(float(x) ** 2 for x in inner)
            assert abs(r[13][i] - sq) <= TOL * sq


@pytest.mark.parametrize("G,iv,where,excl", CASES)
@pytest.mark.parametrize("field", ["price", "lat"])
def test_fminmax(eng, field, G, iv, where, excl):
    got, want = eng.run({field: ("fminmax",)}, G, iv, where, excl)
    g, w = got[(field, "fminmax")], want[(field, "fminmax")]
    for a, b in zip(g, w):
        _same(a, b)
    from knoxdb_tpu_torch.types import FieldType
    from knoxdb_tpu_torch.utils import limbs as TL
    m, b = eng.rows(G, iv, where, excl)
    keys = TL.to_keys64(eng.data[field], FieldType.FLOAT64)
    for i in range(G):
        k = keys[m & (b == i)]
        if len(k):
            assert (int(g[1][i]), int(g[2][i])) == (int(k.min()),
                                                    int(k.max()))
        else:
            assert (int(g[1][i]), int(g[2][i])) == ((1 << 64) - 1, 0)


def test_all_kinds_in_one_call(eng):
    """Several fields and kinds in one plan give what the single calls
    give, and a second call reuses the plan."""
    kinds = {"val": ("moments", "firstlast", "tsruns"),
             "price": ("moments", "firstlast", "fminmax"),
             "lat": ("fminmax", "firstlast")}
    got, want = eng.run(kinds, 24, 30, True, True)
    for k in want:
        for i, (a, b) in enumerate(zip(got[k], want[k])):
            if a.dtype == np.float64 and k[1] in ("moments", "tsruns") \
                    and k != ("val", "moments"):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12)
            else:
                _same(a, b)
    nplans = len(eng.tsc._fns)
    eng.run(kinds, 24, 30, True, True)
    assert len(eng.tsc._fns) == nplans


def test_unknown_kind_raises(eng):
    tplan = TGB.plan_buckets(eng.tsc.d, "ts", T0, 8, 8)
    with pytest.raises(ValueError, match="kinds"):
        eng.tsc.series_scan(None, "ts", {"val": ("median",)}, tplan)
