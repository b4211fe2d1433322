"""knoxdb_tpu_torch on the CPU: a copy of tests/test_sort_series.py with the
port's imports and device="cpu", against the same numpy oracles.

Order-by/top-k and time-series buckets vs numpy oracle
(BASELINE configs #3 time-bucketed series and #4 sort/top-k)."""

from dataclasses import dataclass

import numpy as np
import pytest

import knoxdb_tpu_torch.knox as knox
from knoxdb_tpu_torch.schema.schema import Builder, field_meta
from knoxdb_tpu_torch.series import FillMode, SeriesRequest, run_series
from knoxdb_tpu_torch.types import FieldType


@pytest.fixture
def db(tmp_path):
    d = knox.create_database("s", driver="mem", pack_size=512,
                             background_merge=False, device="cpu")
    yield d
    d.close()


def _mk(db, rng, n=3000):
    sch = (Builder("tx").pk("id")
           .add("ts", FieldType.INT64)
           .add("amount", FieldType.INT64)
           .add("big", FieldType.INT128)
           .finish())
    t = db.create_table(sch)
    ts = np.sort(rng.integers(10**6, 2 * 10**6, n))
    amount = rng.integers(-10**6, 10**6, n)
    big = [int(a) * 10**21 for a in amount]
    t.insert({"id": np.zeros(n, np.uint64), "ts": ts,
              "amount": amount, "big": big})
    t.merge()
    return t, ts, amount, big


def test_topk_asc_desc(db, rng):
    t, ts, amount, big = _mk(db, rng)
    got = t.query().order_by("amount").limit(10).select("amount").rows()
    want = np.sort(amount)[:10]
    np.testing.assert_array_equal(got["amount"], want)
    got = t.query().order_by("amount", desc=True).limit(10) \
        .select("amount").rows()
    np.testing.assert_array_equal(got["amount"], np.sort(amount)[::-1][:10])


def test_topk_with_filter_and_journal(db, rng):
    t, ts, amount, big = _mk(db, rng)
    t.insert({"id": np.zeros(3, np.uint64),
              "ts": np.array([0, 1, 2]),
              "amount": np.array([-10**7, 10**7, 5]),
              "big": [0, 0, 0]})
    got = t.query().where(knox.F("amount") < 0) \
        .order_by("amount").limit(5).select("amount").rows()
    allamt = np.concatenate([amount, [-10**7, 10**7, 5]])
    want = np.sort(allamt[allamt < 0])[:5]
    np.testing.assert_array_equal(got["amount"], want)


def test_topk_wide_order(db, rng):
    t, ts, amount, big = _mk(db, rng)
    got = t.query().order_by("big").limit(7).select("big", "amount").rows()
    order = np.argsort(np.array(big, object))
    want_big = [big[i] for i in order[:7]]
    assert [int(v) for v in got["big"]] == want_big
    np.testing.assert_array_equal(
        np.asarray([int(v) for v in got["amount"]]),
        amount[order[:7]])


def test_full_sort(db, rng):
    t, ts, amount, big = _mk(db, rng, n=500)
    got = t.query().where(knox.F("amount") >= 0) \
        .order_by("amount").select("amount").rows()
    want = np.sort(amount[amount >= 0])
    np.testing.assert_array_equal(got["amount"], want)


def test_series_buckets(db, rng):
    t, ts, amount, big = _mk(db, rng)
    iv = 100_000
    req = SeriesRequest(table=t, time_field="ts", start=10**6, end=2 * 10**6,
                        interval=iv, aggs=[("sum", "amount"),
                                           ("min", "amount"),
                                           ("count", "")],
                        fill=FillMode.NULL)
    out = run_series(req)
    G = 10
    assert len(out["time"]) == G
    for g in range(G):
        lo, hi = 10**6 + g * iv, 10**6 + (g + 1) * iv
        m = (ts >= lo) & (ts < hi)
        assert out["count"][g] == m.sum()
        if m.any():
            assert out[("sum", "amount")][g] == int(amount[m].sum())
            assert out[("min", "amount")][g] == int(amount[m].min())


def test_series_fill_modes(db, rng):
    sch = (Builder("f").pk("id").add("ts", FieldType.INT64)
           .add("v", FieldType.INT64).finish())
    t = db.create_table(sch)
    t.insert({"id": np.zeros(2, np.uint64), "ts": np.array([100, 400]),
              "v": np.array([10, 40])})
    t.merge()
    base = dict(table=t, time_field="ts", start=0, end=500, interval=100,
                aggs=[("sum", "v")])
    out = run_series(SeriesRequest(**base, fill=FillMode.ZERO))
    assert list(out[("sum", "v")]) == [0, 10, 0, 0, 40]
    out = run_series(SeriesRequest(**base, fill=FillMode.LAST))
    assert list(out[("sum", "v")]) == [None, 10, 10, 10, 40]
    out = run_series(SeriesRequest(**base, fill=FillMode.LINEAR))
    assert list(out[("sum", "v")])[2:4] == [20.0, 30.0]
    out = run_series(SeriesRequest(**base, fill=FillMode.NONE))
    assert list(out[("sum", "v")]) == [10, 40]


def test_series_moments_bigG(db, rng):
    """r5: var/mean series above the single-pass group ceiling (G=12288
    buckets > 8192) ride the multi-pass kernels and stay oracle-exact."""
    from knoxdb_tpu_torch.schema.schema import Builder
    from knoxdb_tpu_torch.types import FieldType
    sch = (Builder("bg").pk("id")
           .add("ts", FieldType.UINT64)
           .add("v", FieldType.INT64)
           .finish())
    t = db.create_table(sch)
    n = 1 << 14
    G, iv = 12288, 64
    ts = (10 ** 6 + rng.integers(0, G * iv, n)).astype(np.uint64)
    v = rng.integers(-1 << 20, 1 << 20, n)
    t.insert({"id": np.zeros(n, np.uint64), "ts": ts, "v": v})
    t.merge()
    out = run_series(SeriesRequest(
        table=t, time_field="ts", start=10 ** 6, end=10 ** 6 + G * iv,
        interval=iv, aggs=[("count", ""), ("sum", "v"), ("var", "v")],
        fill=FillMode.NULL))
    assert len(out["time"]) == G
    bid = ((ts - 10 ** 6) // iv).astype(np.int64)
    wc = np.bincount(bid, minlength=G)
    np.testing.assert_array_equal(np.asarray(out["count"], np.int64), wc)
    ws = np.zeros(G, object)
    np.add.at(ws, bid, v.astype(object))
    got_s = out[("sum", "v")]
    for g in np.flatnonzero(wc)[:200]:
        assert int(got_s[g]) == int(ws[g]), g
    # var spot-check vs numpy (sample variance, n>=2)
    import math
    for g in np.flatnonzero(wc >= 2)[:50]:
        vv = v[bid == g].astype(np.float64)
        want = float(np.var(vv, ddof=1))
        gotv = float(out[("var", "v")][g])
        assert math.isclose(gotv, want, rel_tol=1e-9, abs_tol=1e-6), g
