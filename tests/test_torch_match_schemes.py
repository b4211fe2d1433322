"""Every filter mode over every integer column scheme, through
SegmentScanner on one mixed-scheme segment: DELTA (a pk, and a column that
crosses 2^63), RLE, RAW, narrow BITPACK in two width groups, integer and
bytes dictionaries (the dictionary-mask path included), and wide INT128 /
INT256 columns whose packs are BITPACK, CONST and RAW; IN lists of 16, 17
and 2048 keys (the K-way sweep, and the sort membership from 17 keys on).

The port's packed match mask equals knoxdb_tpu's word for word (bitsets,
so the tolerance is 0) and a numpy oracle row for row."""

import numpy as np
import pytest

from knoxdb_tpu_torch.ops import bitset as TBS
from torch_mixed import PACK, Mixed, P, oracle_mask

MODES = ["EQ", "NE", "LT", "LE", "GT", "GE", "RANGE", "IN", "NOT_IN"]
FIELDS = ["id", "d", "r", "w", "a", "k", "s", "big", "h"]


@pytest.fixture(scope="module")
def mx():
    m = Mixed()
    m.check_schemes()
    return m


def _sorted(col):
    return sorted(set(col.tolist()))


def _value(data, field, mode, rng):
    """A constant of the column's own values, so that every mode matches
    some rows and misses others."""
    vals = _sorted(data[field])
    q1, q3 = vals[len(vals) // 4], vals[3 * len(vals) // 4]
    if mode == "RANGE":
        return (q1, q3)
    if mode in ("IN", "NOT_IN"):
        picks = [vals[i] for i in rng.choice(len(vals), 3, replace=False)]
        absent = "zzz" if field == "s" else q1 + 1
        return picks + ([absent] if absent not in set(vals) else [])
    return q3 if mode in ("LT", "LE") else q1


def _check(mx, spec, want):
    rmask, tmask = mx.masks(spec)
    np.testing.assert_array_equal(tmask, rmask)
    got = TBS.np_unpack_mask(tmask.reshape(-1), PACK * P)
    np.testing.assert_array_equal(got, want.astype(bool))
    assert 0 < got.sum() < len(got)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("field", FIELDS)
def test_leaf(mx, rng, field, mode):
    value = _value(mx.data, field, mode, rng)
    _check(mx, ("leaf", field, mode, value),
           oracle_mask(mx.data, field, mode, value))


@pytest.mark.parametrize("nkeys,mode", [(16, "IN"), (17, "IN"),
                                        (2048, "NOT_IN"), (17, "NOT_IN")])
@pytest.mark.parametrize("field", ["id", "d", "r", "w", "a", "k", "big", "h"])
def test_in_lists(mx, rng, field, nkeys, mode):
    """Half of the keys are the column's own values, half lie beside them."""
    vals = _sorted(mx.data[field])
    own = [vals[i] for i in rng.choice(len(vals), min(nkeys // 2, len(vals) // 2),
                                       replace=False)]
    lo, hi = vals[0], vals[-1]
    beside = set()
    while len(own) + len(beside) < nkeys:
        v = lo + int(rng.integers(0, 1 << 62)) % (hi - lo + 1)
        if v not in own:
            beside.add(v)
    keys = own + sorted(beside)
    assert len(keys) == nkeys
    _check(mx, ("leaf", field, mode, keys),
           oracle_mask(mx.data, field, mode, keys))


def test_bytes_regexp_and_sets(mx):
    """The dictionary-mask path of a bytes dictionary."""
    s = mx.data["s"]
    _check(mx, ("leaf", "s", "REGEXP", "^v0[0-4]"),
           np.array([v[:3] in ("v00", "v01", "v02", "v03", "v04")
                     for v in s]))
    keys = ["v003", "v060", "nope", "v117"]
    _check(mx, ("leaf", "s", "NOT_IN", keys),
           oracle_mask(mx.data, "s", "NOT_IN", keys))


def test_or_of_schemes(mx):
    """An OR subtree stays in the rest mask: every leaf runs unfused."""
    d = mx.data
    dq = _sorted(d["d"])[1000]
    spec = ("and",
            ("or", ("leaf", "a", "RANGE", (50, 120)),
             ("leaf", "d", "LT", dq), ("leaf", "r", "GT", 1 << 39)),
            ("leaf", "s", "GE", "v060"))
    want = (((d["a"] >= 50) & (d["a"] <= 120)) | (d["d"] < dq)
            | (d["r"] > 1 << 39)) & (d["s"].astype(str) >= "v060")
    _check(mx, spec, want)
