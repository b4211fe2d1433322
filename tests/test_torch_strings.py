"""knoxdb_tpu_torch on the CPU: a copy of tests/test_strings.py with the
port's imports and device="cpu", against the same numpy oracles.

STRING/BYTES columns: dict-encoded predicates (incl. regex), bloom
pruning, materialization, sort, journal overlay — vs python oracle
(reference string containers + stats prefixes)."""

from dataclasses import dataclass

import numpy as np
import pytest

import knoxdb_tpu_torch.knox as knox
from knoxdb_tpu_torch.schema.schema import Builder
from knoxdb_tpu_torch.types import FieldType, FilterMode, FilterType


WORDS = ["alpha", "beta", "gamma", "delta", "épsilon", "zeta", "eta",
         "theta", "iota", "kappa", "lambda", "mu", "prefix_very_long_name_x",
         "prefix_very_long_name_y", ""]


@pytest.fixture
def db():
    d = knox.create_database("s", driver="mem", pack_size=256,
                             background_merge=False, device="cpu")
    yield d
    d.close()


@pytest.fixture
def tbl(db, rng):
    sch = (Builder("t").pk("id")
           .add("name", FieldType.STRING, filter=FilterType.BLOOM_2B)
           .add("blob", FieldType.BYTES)
           .add("v", FieldType.INT64)
           .finish())
    t = db.create_table(sch)
    n = 2000
    names = rng.choice(WORDS, n)
    blobs = [bytes([int(b), 0, int(b) % 7]) for b in rng.integers(0, 50, n)]
    v = rng.integers(-100, 100, n)
    t.insert({"id": np.zeros(n, np.uint64), "name": list(names),
              "blob": blobs, "v": v})
    t.merge()
    return t, names, blobs, v


def test_string_eq_ne(tbl):
    t, names, blobs, v = tbl
    for w in ["gamma", "épsilon", "", "missing"]:
        got = t.query().where(knox.F("name") == w).count()
        assert got == int((names == w).sum()), w
    got = t.query().where(knox.F("name") != "beta").count()
    assert got == int((names != "beta").sum())


def test_string_range_lt(tbl):
    t, names, blobs, v = tbl
    got = t.query().where(knox.F("name") < "delta").count()
    assert got == sum(1 for x in names if x < "delta")
    got = t.query().where(knox.F("name").between("beta", "kappa")).count()
    assert got == sum(1 for x in names if "beta" <= x <= "kappa")
    # ties beyond the 8-byte prefix
    got = t.query().where(
        knox.F("name") > "prefix_very_long_name_x").count()
    assert got == sum(1 for x in names if x > "prefix_very_long_name_x")


def test_string_in_regex(tbl):
    t, names, blobs, v = tbl
    got = t.query().where(knox.F("name").in_(["alpha", "mu", "nope"])).count()
    assert got == int(np.isin(names, ["alpha", "mu"]).sum())
    got = t.query().where(
        knox.cond("name", FilterMode.REGEXP, r"^.*a$")).count()
    import re
    assert got == sum(1 for x in names if re.search(r"^.*a$", x))


def test_bytes_predicates(tbl):
    t, names, blobs, v = tbl
    probe = blobs[7]
    got = t.query().where(knox.F("blob") == probe).count()
    assert got == sum(1 for b in blobs if b == probe)
    got = t.query().where(knox.F("blob") <= b"\x10\x00\x02").count()
    assert got == sum(1 for b in blobs if b <= b"\x10\x00\x02")


def test_string_materialize_and_mixed_filter(tbl):
    t, names, blobs, v = tbl
    q = t.query().where(knox.F("name") == "kappa", knox.F("v") > 0) \
        .select("name", "blob", "v")
    rows = q.rows()
    m = (names == "kappa") & (v > 0)
    assert len(rows["name"]) == int(m.sum())
    assert all(x == "kappa" for x in rows["name"])
    want_blobs = [b for b, keep in zip(blobs, m) if keep]
    assert list(rows["blob"]) == want_blobs
    np.testing.assert_array_equal(
        np.array([int(x) for x in rows["v"]]), v[m])


def test_string_journal_overlay(tbl):
    t, names, blobs, v = tbl
    t.insert({"id": np.zeros(2, np.uint64),
              "name": ["omega", "alpha"],
              "blob": [b"xx", b"yy"], "v": np.array([1, 2])})
    got = t.query().where(knox.F("name") == "omega").count()
    assert got == 1
    got = t.query().where(knox.F("name") == "alpha").count()
    assert got == int((names == "alpha").sum()) + 1


def test_string_order_by(tbl):
    t, names, blobs, v = tbl
    rows = t.query().order_by("name").limit(20).select("name").rows()
    want = sorted(names)[:20]
    assert list(rows["name"]) == want


def test_string_group_by(tbl):
    t, names, blobs, v = tbl
    out = t.query().group_by("name").aggregate(("sum", "v"), ("count", ""))
    want_keys = sorted(set(names))
    assert [k for k in out["keys"]] == want_keys
    for i, k in enumerate(want_keys):
        m = names == k
        assert out["count"][i] == int(m.sum())
        assert out[("sum", "v")][i] == int(v[m].sum())
