"""knoxdb_tpu_torch on the CPU: a copy of tests/test_float_groups.py with the
port's imports and device="cpu", against the same numpy oracles.

Float group-by aggregates (VERDICT r2 missing #1).

Reference: internal/reducer/reducer.go:24-48 aggregates float64 (sum,
mean, var over floats). Float contract (series.py): sum/avg/var/std via
fixed-order f64 moments — exact for dyadic/integer-valued data, rounded
like the reference's own float64 accumulators otherwise; min/max via
order-preserving keyform compares (exact).
"""

import math

import numpy as np
import pytest

from knoxdb_tpu_torch import knox
from knoxdb_tpu_torch.series import FillMode, SeriesRequest, run_series
from knoxdb_tpu_torch.types import FieldType


import dataclasses


@dataclasses.dataclass
class Row:
    id: int = 0
    grp: int = 0
    ts: int = 0
    price: float = 0.0


def _mkdb(tmp_path, rows, *, merge=True):
    db = knox.create_database("t", driver="file", path=str(tmp_path),
                              pack_size=256, journal_size=1 << 20,
                              background_merge=False, device="cpu")
    t = db.create_table(Row)
    t.insert(rows)
    if merge:
        t.merge()
    return db, t


def _rows(rng, n, dyadic=True):
    out = []
    for i in range(n):
        # dyadic k/64 floats: f64 sums exact in ANY order -> strict
        # equality vs oracle holds (testing/scenario.py uses the same)
        v = (float(rng.integers(-(1 << 20), 1 << 20)) / 64.0 if dyadic
             else float(rng.normal(0, 1e3)))
        out.append(Row(id=i + 1, grp=int(rng.integers(0, 7)),
                       ts=int(i * 10), price=v))
    return out


@pytest.mark.parametrize("merge", [True, False])
def test_group_float_sum_avg_min_max(tmp_path, rng, merge):
    rows = _rows(rng, 600)
    db, t = _mkdb(tmp_path, rows, merge=merge)
    out = t.query().group_by("grp").aggregate(
        ("count", ""), ("sum", "price"), ("avg", "price"),
        ("min", "price"), ("max", "price"), ("var", "price"))
    by_g: dict[int, list] = {}
    for r in rows:
        by_g.setdefault(r.grp, []).append(r.price)
    assert list(out["keys"]) == sorted(by_g)
    for k, c, s, a, mn, mx, vv in zip(out["keys"], out["count"],
                                      out[("sum", "price")],
                                      out[("avg", "price")],
                                      out[("min", "price")],
                                      out[("max", "price")],
                                      out[("var", "price")]):
        vals = by_g[int(k)]
        assert int(c) == len(vals)
        assert float(s) == math.fsum(vals)          # dyadic: exact
        assert float(a) == pytest.approx(math.fsum(vals) / len(vals))
        assert float(mn) == min(vals)
        assert float(mx) == max(vals)
        want_var = (float("nan") if len(vals) < 2
                    else np.var(np.array(vals), ddof=1))
        if math.isnan(want_var):
            assert math.isnan(vv)
        else:
            assert float(vv) == pytest.approx(want_var, rel=1e-9)
    db.close()


def test_group_float_sum_nondyadic(tmp_path, rng):
    rows = _rows(rng, 400, dyadic=False)
    db, t = _mkdb(tmp_path, rows)
    out = t.query().group_by("grp").aggregate(("sum", "price"))
    by_g: dict[int, list] = {}
    for r in rows:
        by_g.setdefault(r.grp, []).append(r.price)
    for k, s in zip(out["keys"], out[("sum", "price")]):
        assert float(s) == pytest.approx(math.fsum(by_g[int(k)]),
                                         rel=1e-12)
    db.close()


def test_series_float_sum_mean_min_max(tmp_path, rng):
    rows = _rows(rng, 500)
    db, t = _mkdb(tmp_path, rows)
    req = SeriesRequest(table=t, time_field="ts", start=0, end=5000,
                        interval=1000, fill=FillMode.NULL,
                        aggs=[("count", ""), ("sum", "price"),
                              ("mean", "price"), ("min", "price"),
                              ("max", "price")])
    out = run_series(req)
    for g in range(5):
        vals = [r.price for r in rows if g * 1000 <= r.ts < (g + 1) * 1000]
        if not vals:
            assert out[("sum", "price")][g] is None
            continue
        assert float(out[("sum", "price")][g]) == math.fsum(vals)
        assert float(out[("mean", "price")][g]) == \
            pytest.approx(math.fsum(vals) / len(vals))
        assert float(out[("min", "price")][g]) == min(vals)
        assert float(out[("max", "price")][g]) == max(vals)
    db.close()


def test_group_float_alp_exact(tmp_path, rng):
    """Decimal-valued floats ALP-encode; group sums must still be exact
    (moments path decodes ALP packs exactly)."""
    rows = []
    for i in range(512):
        rows.append(Row(id=i + 1, grp=int(rng.integers(0, 4)),
                        ts=i, price=float(rng.integers(0, 10**6)) / 100.0))
    db, t = _mkdb(tmp_path, rows)
    from knoxdb_tpu_torch.encode.schemes import Scheme
    seg = t._t.segments[0].seg
    assert any(p.scheme == Scheme.ALP
               for p in seg.columns["price"].packs)
    out = t.query().group_by("grp").aggregate(
        ("sum", "price"), ("min", "price"), ("max", "price"))
    by_g: dict[int, list] = {}
    for r in rows:
        by_g.setdefault(r.grp, []).append(r.price)
    for k, s, mn, mx in zip(out["keys"], out[("sum", "price")],
                            out[("min", "price")], out[("max", "price")]):
        vals = by_g[int(k)]
        assert float(s) == pytest.approx(math.fsum(vals), rel=1e-12)
        assert float(mn) == min(vals)
        assert float(mx) == max(vals)
    db.close()
