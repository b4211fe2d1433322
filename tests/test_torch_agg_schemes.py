"""sum / min / max / avg per column scheme through SegmentScanner.scan on
the mixed-scheme segment (DELTA, RLE, RAW, narrow BITPACK in two groups,
DICT, and INT128 / INT256 columns of BITPACK, CONST and RAW packs), and
group_scan over DELTA, RLE and RAW value columns.

Integer aggregates are exact python ints: the port equals knoxdb_tpu and a
python-int oracle, tolerance 0."""

import numpy as np
import pytest

from knoxdb_tpu.exec.scan import AggSpec as RAgg
from knoxdb_tpu_torch.exec.scan import AggSpec as TAgg
from knoxdb_tpu_torch.ops import scan_kernels as SK
from torch_mixed import Mixed

FIELDS = ["id", "d", "r", "w", "a", "k", "big", "h"]


@pytest.fixture(scope="module")
def mx():
    m = Mixed()
    m.check_schemes()
    return m


def _filters(d):
    return {
        "all": (None, np.ones(len(d["id"]), bool)),
        "range": (("leaf", "a", "RANGE", (20, 9000)),
                  (d["a"] >= 20) & (d["a"] <= 9000)),
        # leaves packs 0-2 empty
        "half": (("leaf", "a", "GT", 500), d["a"] > 500),
        "none": (("leaf", "a", "GT", 1 << 40), np.zeros(len(d["id"]), bool)),
        "or": (("or", ("leaf", "r", "LT", -(1 << 39)),
                ("leaf", "k", "LE", int(np.median(d["k"])))),
               (d["r"] < -(1 << 39)) | (d["k"] <= int(np.median(d["k"])))),
    }


@pytest.mark.parametrize("fname", ["all", "range", "half", "none", "or"])
@pytest.mark.parametrize("field", FIELDS)
def test_aggs(mx, field, fname):
    spec, m = _filters(mx.data)[fname]
    ops = ["count", "sum", "min", "max", "avg"]
    rtree, ttree = mx.trees(spec) if spec else (None, None)
    r = mx.rsc.scan(rtree, [RAgg(op, field if op != "count" else "")
                            for op in ops])
    t = mx.tsc.scan(ttree, [TAgg(op, field if op != "count" else "")
                            for op in ops])
    assert t.count == r.count == int(m.sum())
    assert t.aggs == r.aggs
    vals = [int(v) for v in mx.data[field][m]]
    want_sum = sum(vals)
    assert t.aggs[("sum", field)] == want_sum
    assert t.aggs[("min", field)] == (min(vals) if vals else None)
    assert t.aggs[("max", field)] == (max(vals) if vals else None)
    assert t.aggs[("avg", field)] == (want_sum / len(vals) if vals else None)


def test_unfused_sums_take_the_popcount_kernel(mx):
    """The two-group BITPACK column does not fuse: its sums run the
    popcount wrapper once per group, and an OR leaf the ladder wrapper."""
    before = dict(SK.PLAIN_CALLS)
    _rtree, ttree = mx.trees(("or", ("leaf", "a", "LT", 100),
                              ("leaf", "a", "GT", 30_000)))
    mx.tsc.scan(ttree, [TAgg("sum", "a")])
    ran = {k: SK.PLAIN_CALLS[k] - before[k] for k in before}
    assert ran["masked_plane_popcounts"] == 2
    assert ran["range_mask_count"] == 4        # 2 leaves x 2 groups
    assert ran["fused_tree_agg"] == 1


@pytest.mark.parametrize("minmax", [False, True])
def test_group_scan_over_schemes(mx, minmax):
    """group by the DICT column k, aggregating RLE, DELTA and RAW value
    columns (exec/device.group_decode_halves / group_decode_keys)."""
    fields = ["r", "d", "w"]
    rtree, ttree = mx.trees(("leaf", "a", "GE", 10))
    rplan, rcounts, rres = mx.rsc.group_scan(rtree, "k", fields,
                                             minmax=minmax)
    tplan, tcounts, tres = mx.tsc.group_scan(ttree, "k", fields,
                                             minmax=minmax)
    np.testing.assert_array_equal(tcounts, np.asarray(rcounts))
    m = mx.data["a"] >= 10
    for f in fields:
        rs, rmn, rmx = rres[f]
        ts, tmn, tmx = tres[f]
        assert [int(x) for x in ts] == [int(x) for x in rs]
        np.testing.assert_array_equal(tmn, np.asarray(rmn))
        np.testing.assert_array_equal(tmx, np.asarray(rmx))
    keys = np.asarray(tplan.keys)
    for gi in (0, len(keys) // 2, len(keys) - 1):
        sel = m & (mx.data["k"] == keys[gi])
        assert int(tcounts[gi]) == int(sel.sum())
        bias = 1 << 63
        assert int(tres["r"][0][gi]) == sum(int(v) + bias
                                            for v in mx.data["r"][sel])


def test_group_by_delta_column(mx):
    """Group ids from a DELTA-coded key column (the dense-range recipe)."""
    rtree, ttree = mx.trees(("leaf", "a", "GE", 10))
    _rp, rcounts, rres = mx.rsc.group_scan(rtree, "id", ["a"], minmax=False)
    _tp, tcounts, tres = mx.tsc.group_scan(ttree, "id", ["a"], minmax=False)
    np.testing.assert_array_equal(tcounts, np.asarray(rcounts))
    assert [int(x) for x in tres["a"][0]] == [int(x) for x in rres["a"][0]]
    assert int(tcounts.sum()) == int((mx.data["a"] >= 10).sum())


@pytest.mark.parametrize("fname", ["all", "half", "none"])
def test_float_column_aggs(mx, fname):
    """The FLOAT64 column (ALP packs beside a keyform pack): the ALP packs'
    exact rational sum plus the keyform pack's pairwise float sum, min and
    max in the value domain; bit-identical with the reference."""
    spec, m = _filters(mx.data)[fname]
    ops = ["count", "sum", "min", "max", "avg"]
    rtree, ttree = mx.trees(spec) if spec else (None, None)
    r = mx.rsc.scan(rtree, [RAgg(op, "f" if op != "count" else "")
                            for op in ops])
    t = mx.tsc.scan(ttree, [TAgg(op, "f" if op != "count" else "")
                            for op in ops])
    assert t.count == r.count == int(m.sum())
    assert t.aggs == r.aggs
    vals = mx.data["f"][m]
    assert t.aggs[("min", "f")] == (vals.min() if len(vals) else None)
    assert t.aggs[("max", "f")] == (vals.max() if len(vals) else None)
    if len(vals):
        assert abs(t.aggs[("sum", "f")] - vals.sum()) <= 1e-9 * len(vals)
