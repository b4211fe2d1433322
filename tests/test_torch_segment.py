"""knoxdb_tpu_torch host build vs the knoxdb_tpu reference: the port's
build_segment must give the reference's packs bit for bit, and
segment_from_reference must carry a reference segment over unchanged."""

import numpy as np
import pytest

from knoxdb_tpu.pack import segment as RSEG
from knoxdb_tpu.schema.schema import Builder as RBuilder
from knoxdb_tpu.types import FieldType as RFT
from knoxdb_tpu_torch.pack import segment as TSEG
from knoxdb_tpu_torch.schema.schema import Builder as TBuilder
from knoxdb_tpu_torch.types import FieldType as TFT

_PACK_ATTRS = ("n", "nlimbs", "width", "min_key", "k", "card", "exp")
_ARRAY_ATTRS = ("planes", "values", "ends", "dict_keys")


def _arr_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a, b)


def assert_segments_equal(r, t):
    """Every pack, stat and header field of reference segment r equals
    port segment t."""
    assert [(f.name, int(f.type), f.is_pk, int(f.filter))
            for f in r.schema.fields] == \
        [(f.name, int(f.type), f.is_pk, int(f.filter))
         for f in t.schema.fields]
    assert (r.pack_size, r.nrows_total, r.epoch) == \
        (t.pack_size, t.nrows_total, t.epoch)
    np.testing.assert_array_equal(r.nrows, t.nrows)
    assert list(r.columns) == list(t.columns)
    for name, rc in r.columns.items():
        tc = t.columns[name]
        assert (rc.wide, rc.wide_bases) == (tc.wide, tc.wide_bases), name
        assert len(rc.packs) == len(tc.packs)
        for j, (rp, tp) in enumerate(zip(rc.packs, tc.packs)):
            where = f"{name} pack {j}"
            assert int(rp.scheme) == int(tp.scheme), where
            for a in _PACK_ATTRS:
                assert getattr(rp, a) == getattr(tp, a), f"{where} {a}"
            for a in _ARRAY_ATTRS:
                assert _arr_equal(getattr(rp, a), getattr(tp, a)), \
                    f"{where} {a}"
            assert rp.dict_bytes == tp.dict_bytes, where
    np.testing.assert_array_equal(r.stats.rid_base, t.stats.rid_base)
    assert list(r.stats.fields) == list(t.stats.fields)
    for name, rs in r.stats.fields.items():
        ts = t.stats.fields[name]
        assert _arr_equal(rs.min_key, ts.min_key), name
        assert _arr_equal(rs.max_key, ts.max_key), name
        assert _arr_equal(rs.bloom_words, ts.bloom_words), name
        assert (int(rs.filter_type), rs.is_prefix) == \
            (int(ts.filter_type), ts.is_prefix), name


def _data(rng, n):
    return {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "u64": rng.integers(0, 1 << 40, n, dtype=np.uint64),
        "i64": rng.integers(-1 << 33, 1 << 33, n, dtype=np.int64),
        "u32": rng.integers(0, 1 << 20, n, dtype=np.uint64),
        "lowcard": np.array([7, 900, 12345, 99], np.uint64)[
            rng.integers(0, 4, n)],
        "const": np.full(n, 42, np.int64),
        "s": np.array(["aa", "bb", "cc"], object)[rng.integers(0, 3, n)],
        "f": np.round(rng.normal(0, 100, n), 2),
    }


_COLUMNS = [("u64", "UINT64", ""), ("i64", "INT64", ""),
            ("u32", "UINT32", "bloom"), ("lowcard", "UINT64", ""),
            ("const", "INT64", ""), ("s", "STRING", "bloom"),
            ("f", "FLOAT64", "")]


def _schemas():
    out = []
    for B, FT in ((RBuilder, RFT), (TBuilder, TFT)):
        b = B("t").pk("id")
        for name, ft, flt in _COLUMNS:
            b = b.add(name, FT[ft], filter=flt)
        out.append(b.finish())
    return out


@pytest.mark.parametrize("n", [2048 * 8, 2048 * 5 + 77])
def test_build_segment_matches_reference(rng, n):
    data = _data(rng, n)
    rsch, tsch = _schemas()
    rseg = RSEG.build_segment(rsch, data, pack_size=2048)
    tseg = TSEG.build_segment(tsch, data, pack_size=2048)
    assert_segments_equal(rseg, tseg)
    # the columns cover the schemes the slice scans
    from knoxdb_tpu_torch.encode.schemes import Scheme
    schemes = {name: {p.scheme for p in c.packs}
               for name, c in tseg.columns.items()}
    assert schemes["u64"] == {Scheme.BITPACK}
    assert schemes["lowcard"] == {Scheme.DICT}
    assert schemes["const"] == {Scheme.CONST}
    assert schemes["s"] == {Scheme.DICT}


def test_segment_from_reference_equals_own_build(rng):
    data = _data(rng, 2048 * 4 + 5)
    rsch, tsch = _schemas()
    rseg = RSEG.build_segment(rsch, data, pack_size=2048)
    carried = TSEG.segment_from_reference(rseg)
    own = TSEG.build_segment(tsch, data, pack_size=2048)
    assert_segments_equal(rseg, carried)
    assert_segments_equal(own, carried)
    assert type(carried) is TSEG.Segment
    assert type(carried.columns["u64"].packs[0]) is \
        type(own.columns["u64"].packs[0])


def test_float_packs_carried_unchanged(rng):
    """segment_from_reference carries ALP packs (base, exponent, planes) and
    keyform float packs as they are, and the port's own build gives the
    same packs."""
    from knoxdb_tpu_torch.encode.schemes import Scheme
    n = 1024 * 4
    f = np.round(rng.uniform(-50.0, 50.0, n), 3)
    f[1024:2048] = rng.standard_normal(1024)          # no exponent fits
    f[2048:3072] = 7.25                               # one value
    data = {"id": np.arange(1, n + 1, dtype=np.uint64), "f": f,
            "g": rng.standard_normal(n).astype(np.float32)}
    schs = []
    for B, FT in ((RBuilder, RFT), (TBuilder, TFT)):
        schs.append(B("t").pk("id").add("f", FT.FLOAT64)
                    .add("g", FT.FLOAT32).finish())
    rseg = RSEG.build_segment(schs[0], data, pack_size=1024)
    carried = TSEG.segment_from_reference(rseg)
    own = TSEG.build_segment(schs[1], data, pack_size=1024)
    assert_segments_equal(rseg, carried)
    assert_segments_equal(own, carried)
    packs = carried.columns["f"].packs
    assert [p.scheme for p in packs][0] == Scheme.ALP
    assert packs[1].scheme != Scheme.ALP
    for rp, tp in zip(rseg.columns["f"].packs, packs):
        assert int(tp.scheme) == int(rp.scheme)
        assert (tp.min_key, tp.exp, tp.width) == (rp.min_key, rp.exp,
                                                  rp.width)
        if rp.planes is not None:
            np.testing.assert_array_equal(tp.planes, rp.planes)
    assert packs[0].exp == 3 and isinstance(packs[0].min_key, int)
