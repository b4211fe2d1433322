"""The slice end to end: knoxdb_tpu_torch SegmentScanner.scan vs the
knoxdb_tpu reference on the very same packs (segment_from_reference), and
both vs a numpy oracle. Counts and every aggregate must be equal, and the
port must have taken its fused kernel (the plain version's call counter
rises on the CPU)."""

import numpy as np
import pytest

from knoxdb_tpu.exec.device import DeviceSegment as RDevSeg
from knoxdb_tpu.exec.scan import AggSpec as RAgg
from knoxdb_tpu.exec.scan import SegmentScanner as RScanner
from knoxdb_tpu.pack.segment import build_segment as r_build
from knoxdb_tpu.query import filter as RQ
from knoxdb_tpu.schema.schema import Builder as RBuilder
from knoxdb_tpu.types import FieldType as RFT
from knoxdb_tpu.types import FilterMode as RFM
from knoxdb_tpu_torch.encode.schemes import Scheme
from knoxdb_tpu_torch.exec.device import DeviceSegment as TDevSeg
from knoxdb_tpu_torch.exec.scan import AggSpec as TAgg
from knoxdb_tpu_torch.exec.scan import SegmentScanner as TScanner
from knoxdb_tpu_torch.ops import bitset as TBS
from knoxdb_tpu_torch.ops import scan_kernels as SK
from knoxdb_tpu_torch.pack.segment import segment_from_reference
from knoxdb_tpu_torch.query import filter as TQ
from knoxdb_tpu_torch.types import FilterMode as TFM

PACK = 2048


def _tree(Q, FM, sch, spec):
    """Neutral tree spec -> one package's optimized filter tree. spec is
    ("leaf", field, mode, value) or ("and"|"or", child, ...)."""
    def build(s):
        if s[0] == "leaf":
            return Q.leaf(Q.Filter(sch.field(s[1]), FM[s[2]], s[3]))
        kids = [build(c) for c in s[1:]]
        return (Q.and_ if s[0] == "and" else Q.or_)(*kids)
    return build(spec).optimize()


class Engines:
    """One reference segment, scanned by both engines."""

    def __init__(self, cols, data):
        b = RBuilder("t").pk("id")
        for name, ft in cols:
            b = b.add(name, RFT[ft])
        self.rsch = b.finish()
        self.data = data
        self.rseg = r_build(self.rsch, data, pack_size=PACK)
        self.tseg = segment_from_reference(self.rseg)
        self.rsc = RScanner(RDevSeg(self.rseg))
        self.tsc = TScanner(TDevSeg(self.tseg, "cpu"))

    def scan(self, spec, aggs, kernel="fused_tree_agg", **kw):
        """Scan with both engines; assert they agree and that the port ran
        `kernel` once. Returns the port's ScanResult."""
        rtree = tspec = None
        if spec is not None:
            rtree = _tree(RQ, RFM, self.rsch, spec)
            tspec = _tree(TQ, TFM, self.tseg.schema, spec)
        r = self.rsc.scan(rtree, [RAgg(*a) for a in aggs], **kw)
        before = dict(SK.PLAIN_CALLS)
        t = self.tsc.scan(tspec, [TAgg(*a) for a in aggs], **kw)
        ran = {k: SK.PLAIN_CALLS[k] - before[k] for k in before}
        assert ran == {k: int(k == kernel) for k in before}, ran
        assert t.count == r.count
        assert t.aggs == r.aggs
        return t


def _oracle(data, m, aggs):
    out = {}
    for op, f in aggs:
        if op == "count":
            out[(op, f)] = int(m.sum())
        elif not m.any():
            out[(op, f)] = 0 if op == "sum" else None
        elif op == "sum":
            out[(op, f)] = int(data[f][m].astype(object).sum())
        else:
            out[(op, f)] = int(getattr(data[f][m], op)())
    return out


def _check(eng, spec, aggs, m, **kw):
    res = eng.scan(spec, aggs, **kw)
    assert res.count == int(m.sum())
    assert res.aggs == _oracle(eng.data, m, aggs)
    return res


def _bench_data(n, bal_bits, seed):
    """The schema and data of bench.py / __graft_entry__, n rows."""
    rng = np.random.default_rng(seed)
    return {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "val": rng.integers(0, 1 << 16, n, dtype=np.uint64),
        "bal": rng.integers(-1 << bal_bits, 1 << bal_bits, n,
                            dtype=np.int64),
    }


_BENCH_COLS = [("val", "UINT64"), ("bal", "INT64")]
_CFG1 = ("leaf", "val", "RANGE", (1000, 50000))
_TWO_LEAF = ("and", _CFG1, ("leaf", "bal", "GT", 0))
_ENTRY_AGGS = [("count", ""), ("sum", "bal"), ("min", "val"),
               ("max", "val")]


@pytest.fixture(scope="module")
def bench():
    return Engines(_BENCH_COLS, _bench_data(PACK * 16, 40, 0xBEEF))


def test_config1(bench):
    d = bench.data
    m = (d["val"] >= 1000) & (d["val"] <= 50000)
    _check(bench, _CFG1, [("count", ""), ("sum", "val")], m,
           kernel="fused_range_sum_masked")


def test_two_leaf_check(bench):
    d = bench.data
    m = (d["val"] >= 1000) & (d["val"] <= 50000) & (d["bal"] > 0)
    _check(bench, _TWO_LEAF, [("count", ""), ("sum", "bal")], m)
    _check(bench, _TWO_LEAF, _ENTRY_AGGS, m)


@pytest.mark.parametrize("P", [4, 16])
def test_entry_query(P):
    """__graft_entry__.entry(): P = 4 runs the reference's unfused XLA plan
    (its Pallas plan needs P % 8 == 0); the port runs its kernel at both."""
    eng = Engines(_BENCH_COLS, _bench_data(PACK * P, 30, 0))
    d = eng.data
    m = (d["val"] >= 1000) & (d["val"] <= 50000) & (d["bal"] > 0)
    _check(eng, _TWO_LEAF, _ENTRY_AGGS, m)


def test_dict_leaves(rng):
    n = PACK * 8
    svals = np.array(["aa", "bb", "cc", "dd", "zz"], object)
    kpool = np.array([10, 20, 30, 40, 500_000], np.uint64)
    data = {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "s": svals[rng.integers(0, 5, n)],
        "k": kpool[rng.integers(0, 5, n)],
        "v": rng.integers(0, 1 << 30, n, dtype=np.uint64),
    }
    eng = Engines([("s", "STRING"), ("k", "UINT32"), ("v", "UINT64")], data)
    assert eng.tsc.d.column("s").groups[0].scheme == Scheme.DICT
    assert eng.tsc.d.column("k").groups[0].scheme == Scheme.DICT
    s, k = data["s"], data["k"]
    cases = [
        (("s", "EQ", "zz"), s == "zz"),
        (("s", "EQ", "qq"), np.zeros(n, bool)),          # miss everywhere
        (("s", "RANGE", ("bb", "dd")), (s >= "bb") & (s <= "dd")),
        (("s", "GT", "cc"), s > "cc"),
        (("k", "EQ", 500_000), k == 500_000),
        (("k", "LE", 20), k <= 20),
        (("k", "RANGE", (20, 40)), (k >= 20) & (k <= 40)),
    ]
    aggs = [("count", ""), ("sum", "v"), ("max", "v")]
    for (f, mode, val), m_leaf in cases:
        spec = ("and", ("leaf", f, mode, val), ("leaf", "v", "GT", 1000))
        _check(eng, spec, aggs, m_leaf & (data["v"] > 1000))
    # dictionary leaves the kernel does not take stay in the rest mask
    _check(eng, ("and", ("leaf", "k", "IN", [10, 40, 7]),
                 ("leaf", "s", "NE", "bb")), aggs,
           np.isin(k, [10, 40]) & (s != "bb"))


@pytest.fixture(scope="module")
def mixed():
    """BITPACK, CONST and two-group columns, with per-pack zone maps that
    the `ts` ranges can decide."""
    rng = np.random.default_rng(7)
    P = 8
    n = PACK * P
    pack = np.arange(n) // PACK
    data = {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "a": rng.integers(0, 60_000, n, dtype=np.uint64),
        "b": rng.integers(-1 << 31, 1 << 31, n, dtype=np.int64),
        # packs 0-1 constant: a CONST group beside a BITPACK one
        "c": np.where(pack < 2, 42, rng.integers(-1000, 1000, n)),
        # packs 0-3 fit 8 bits, packs 4-7 16 bits: two device groups
        "g": np.where(pack < 4, rng.integers(0, 200, n),
                      rng.integers(0, 40_000, n)).astype(np.uint64),
        "ts": (pack * 100_000 + rng.integers(0, 50_000, n)).astype(np.uint64),
    }
    eng = Engines([("a", "UINT64"), ("b", "INT64"), ("c", "INT64"),
                   ("g", "UINT64"), ("ts", "UINT64")], data)
    assert len(eng.tsc.d.column("g").groups) == 2
    assert eng.tsc.d.column("c").groups[0].scheme == Scheme.CONST
    return eng


def test_or_tree(mixed):
    d = mixed.data
    spec = ("or", ("leaf", "a", "LT", 500), ("leaf", "b", "GT", 1 << 30))
    m = (d["a"] < 500) | (d["b"] > 1 << 30)
    _check(mixed, spec, [("count", ""), ("sum", "a"), ("min", "b"),
                         ("max", "b")], m)


def test_rest_mask_leaves(mixed):
    """IN and NE leaves and a leaf on a CONST + BITPACK column stay in the
    rest mask; the kernel takes the range leaf and the aggregates."""
    d = mixed.data
    keys = [int(x) for x in d["a"][:4000:3]] + [70_000]
    spec = ("and", ("leaf", "a", "IN", keys), ("leaf", "b", "NE", 0),
            ("leaf", "c", "GE", 0), ("leaf", "a", "GT", 100))
    m = np.isin(d["a"], keys) & (d["b"] != 0) & (d["c"] >= 0) \
        & (d["a"] > 100)
    _check(mixed, spec, [("count", ""), ("sum", "b"), ("min", "a")], m)
    _check(mixed, ("and", ("leaf", "c", "LT", 42), ("leaf", "a", "GT", 9)),
           [("count", ""), ("sum", "a")], (d["c"] < 42) & (d["a"] > 9))


def test_multi_group_column(mixed):
    """A column of two device groups is neither a fused leaf nor a fused
    aggregate: its leaf scatters into the rest mask and its aggregates run
    after the kernel, per group."""
    d = mixed.data
    spec = ("and", ("leaf", "g", "GE", 150), ("leaf", "a", "RANGE",
                                              (1000, 40_000)))
    m = (d["g"] >= 150) & (d["a"] >= 1000) & (d["a"] <= 40_000)
    aggs = [("count", ""), ("sum", "g"), ("min", "g"), ("max", "g")]
    _check(mixed, spec, aggs, m)
    # with a sum on the fused leaf's column the one-leaf kernel runs
    _check(mixed, spec, aggs + [("sum", "a")], m,
           kernel="fused_range_sum_masked")


def test_exclude_and_include_words(mixed, rng):
    d = mixed.data
    n = len(d["a"])
    excl_rows = rng.random(n) < 0.3
    incl_rows = rng.random(n) < 0.8
    P = n // PACK
    excl = TBS.np_pack_mask(excl_rows).reshape(P, -1)
    incl = TBS.np_pack_mask(incl_rows).reshape(P, -1)
    spec = ("leaf", "a", "RANGE", (1000, 50_000))
    m = (d["a"] >= 1000) & (d["a"] <= 50_000)
    aggs = [("count", ""), ("sum", "a")]
    _check(mixed, spec, aggs, m & ~excl_rows, kernel="fused_range_sum_masked",
           exclude_words=excl)
    _check(mixed, spec, aggs, m & ~excl_rows & incl_rows,
           kernel="fused_range_sum_masked", exclude_words=excl,
           include_words=incl)


def test_zone_map_pruning(mixed):
    d = mixed.data
    aggs = [("count", ""), ("sum", "a"), ("min", "ts"), ("max", "ts")]
    # packs 0-1 NONE, 2-3 ALL, 4 MAYBE, 5-7 NONE
    spec = ("and", ("leaf", "ts", "RANGE", (150_000, 420_000)),
            ("leaf", "a", "GT", 5000))
    m = (d["ts"] >= 150_000) & (d["ts"] <= 420_000) & (d["a"] > 5000)
    res = _check(mixed, spec, aggs, m)
    assert res.stats["packs_matched"] == 3
    # fully decided leaves skip their kernels: all packs ALL, then NONE
    _check(mixed, ("leaf", "ts", "GE", 0), aggs, np.ones(len(m), bool))
    _check(mixed, ("leaf", "a", "GT", 1 << 40), aggs, np.zeros(len(m), bool))


def test_no_tree_and_count_only(mixed):
    d = mixed.data
    _check(mixed, None, [("count", ""), ("sum", "b"), ("max", "a")],
           np.ones(len(d["a"]), bool))
    _check(mixed, ("and", ("leaf", "a", "LE", 30_000),
                   ("leaf", "b", "GE", -5)), [("count", "")],
           (d["a"] <= 30_000) & (d["b"] >= -5))
