"""knoxdb_tpu_torch's series runner (series.run_series over engine Tables)
against knoxdb_tpu's and a python oracle of the upstream reducer
semantics: every reducer (count, sum, mean, min, max, first, last, var,
std and the *_join family) on an integer and a float column, under every
FillMode, over one segment, two interleaved segments, a journal overlay
and sparse buckets (mirrors tests/test_series_reducers.py). Exact values
are equal; float values within the reference test's rel 1e-9."""

import math

import numpy as np
import pytest

import knoxdb_tpu.series as RSER
import knoxdb_tpu_torch.series as TSER

from torch_engine_pair import SIDES, Pair

START, END, IV = 1000, 2000, 100
EXT = ["first", "last", "var", "std", "first_join", "last_join",
       "min_join", "max_join", "mean_join", "var_join", "std_join"]
BASIC = ["count", "sum", "mean", "min", "max"]
FILLS = ["none", "null", "zero", "last", "linear"]
COLS = [("ts", "INT64"), ("v", "INT64"), ("x", "FLOAT64")]


def oracle(ts, vals, op):
    """Per-bucket upstream reducer semantics; None for empty buckets."""
    G = -(-(END - START) // IV)
    out = [None] * G
    for g in range(G):
        lo = START + g * IV
        m = (ts >= lo) & (ts < lo + IV)
        if not m.any():
            continue
        order = np.argsort(ts[m], kind="stable")
        tv, vv = ts[m][order], vals[m][order]
        base = op
        if op.endswith("_join"):
            uts = np.unique(tv)
            vv = np.array([vv[tv == u].sum() for u in uts], vv.dtype)
            base = op[:-5]
        f = vv.astype(np.float64)
        out[g] = {"count": len(vv), "sum": vv.sum(), "mean": f.mean(),
                  "min": vv.min(), "max": vv.max(), "first": vv[0],
                  "last": vv[-1],
                  "var": float("nan") if len(vv) < 2
                  else float(np.var(f, ddof=1)),
                  "std": float("nan") if len(vv) < 2
                  else float(np.std(f, ddof=1))}[base]
    return out


def close(a, b):
    if a is None or b is None:
        return a is None and b is None
    fa, fb = float(a), float(b)
    if math.isnan(fa) or math.isnan(fb):
        return math.isnan(fa) and math.isnan(fb)
    return fa == pytest.approx(fb, rel=1e-9, abs=1e-9)


def _exact(a, b):
    if isinstance(a, float) and isinstance(b, float) \
            and math.isnan(a) and math.isnan(b):
        return True
    return a == b and type(a) is type(b)


def _layout(tmp_path, kind, rng):
    p = Pair(tmp_path, "sr", COLS, driver="mem")
    if kind == "sparse":
        ts = np.array([1000, 1150, 1150, 1900, 1999])
        v = np.array([5, 7, -2, 9, 4])
        x = np.array([0.5, -1.25, 3.0, 2.0, 0.125])
        p.insert({"id": np.arange(1, 6, dtype=np.uint64), "ts": ts, "v": v,
                  "x": x})
        p.merge()
        return p, ts, v, x
    n = 1500
    # spills outside the window; heavy collisions exercise run coalescing
    ts = (rng.integers(900, 2100, n) // 7) * 7
    v = rng.integers(-1000, 1000, n)
    x = np.round(rng.normal(0, 10, n), 3)
    cut = n // 2 if kind == "two_segments" else n
    p.insert({"id": np.arange(1, cut + 1, dtype=np.uint64), "ts": ts[:cut],
              "v": v[:cut], "x": x[:cut]})
    p.merge()
    if cut < n:
        p.insert({"id": np.arange(cut + 1, n + 1, dtype=np.uint64),
                  "ts": ts[cut:], "v": v[cut:], "x": x[cut:]})
        p.merge()
    if kind == "journal":
        nj = 120
        jts = (rng.integers(900, 2100, nj) // 7) * 7
        jv = rng.integers(-1000, 1000, nj)
        jx = np.round(rng.normal(0, 10, nj), 3)
        p.insert({"id": np.arange(n + 1, n + nj + 1, dtype=np.uint64),
                  "ts": jts, "v": jv, "x": jx})
        ts, v, x = (np.concatenate(a) for a in ((ts, jts), (v, jv),
                                                (x, jx)))
    return p, ts, v, x


def _run(p, aggs, fill, where=None):
    out = {}
    for side in SIDES:
        S = RSER if side == "ref" else TSER
        out[side] = S.run_series(S.SeriesRequest(
            table=p.tab[side], time_field="ts", start=START, end=END,
            interval=IV, aggs=aggs, fill=fill, where=where))
    return out["ref"], out["port"]


@pytest.mark.parametrize("kind", ["one_segment", "two_segments", "journal",
                                  "sparse"])
@pytest.mark.parametrize("fill", FILLS)
def test_run_series_every_reducer_and_fill(tmp_path, rng, kind, fill):
    p, ts, v, x = _layout(tmp_path, kind, rng)
    aggs = [(op, f) for f in ("v", "x") for op in BASIC + EXT
            if op != "count"] + [("count", "")]
    r, t = _run(p, aggs, fill)
    assert set(r) == set(t)
    np.testing.assert_array_equal(t["time"], r["time"])
    np.testing.assert_array_equal(t["count"], r["count"])
    assert t["time"].dtype == r["time"].dtype
    keep = [c is not None for c in oracle(ts, v, "count")] \
        if fill == "none" else None
    for op, f in aggs:
        if op == "count":
            continue
        got, want = t[(op, f)], r[(op, f)]
        assert len(got) == len(want)
        exact = f == "v" and op in ("sum", "min", "max", "first", "last",
                                    "first_join", "last_join", "min_join",
                                    "max_join")
        for g, (a, b) in enumerate(zip(got.tolist(), want.tolist())):
            ok = _exact(a, b) if exact else close(a, b)
            assert ok, f"{op}({f}) bucket {g}: {a!r} != {b!r}"
        if fill in ("null", "none"):
            o = oracle(ts, v if f == "v" else x, op)
            if keep is not None:
                o = [w for w, k in zip(o, keep) if k]
            for g, (a, w) in enumerate(zip(got.tolist(), o)):
                assert close(a, w), f"{op}({f}) bucket {g} vs oracle"
    p.close()


def test_run_series_where_and_errors(tmp_path, rng):
    p, ts, v, x = _layout(tmp_path, "journal", rng)
    from torch_engine_pair import tree
    where = {s: tree(s, p.tab[s].schema, ("leaf", "v", "GT", 0))
             for s in SIDES}
    out = {}
    for side in SIDES:
        S = RSER if side == "ref" else TSER
        out[side] = S.run_series(S.SeriesRequest(
            table=p.tab[side], time_field="ts", start=START, end=END,
            interval=IV, aggs=[("sum", "v"), ("max", "x"), ("last", "v")],
            fill="zero", where=where[side]))
    for k in out["ref"]:
        a, b = out["port"][k], out["ref"][k]
        if k in ("time", "count"):
            np.testing.assert_array_equal(a, b)
        else:
            assert all(close(x_, y_) for x_, y_ in zip(a.tolist(),
                                                        b.tolist()))
    with pytest.raises(ValueError, match="series reducer"):
        TSER.run_series(TSER.SeriesRequest(
            table=p.tab["port"], time_field="ts", start=START, end=END,
            interval=IV, aggs=[("median", "v")]))
    with pytest.raises(ValueError, match="exceeds"):
        TSER.run_series(TSER.SeriesRequest(
            table=p.tab["port"], time_field="ts", start=0, end=1 << 40,
            interval=1, aggs=[("sum", "v")]))
    p.close()
