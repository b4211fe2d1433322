"""Row materialization: SegmentScanner.scan(project=, limit=) and
scan_stream of knoxdb_tpu_torch against knoxdb_tpu's on the very same
packs (segment_from_reference), and both against numpy: the row ids and
every projected column's values, bytes dictionaries included."""

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
from knoxdb_tpu_torch.pack.segment import segment_from_reference
from knoxdb_tpu_torch.query import filter as TQ
from knoxdb_tpu_torch.types import FilterMode as TFM

PACK = 2048
P = 8
COLS = [("a", "UINT64"), ("b", "INT64"), ("c", "INT64"), ("g", "UINT64"),
        ("k", "UINT32"), ("s", "STRING")]
ALL = [name for name, _ in COLS]      # the sequential pk "id" is DELTA


def _tree(Q, FM, sch, spec):
    def build(s):
        if s[0] == "leaf":
            return Q.leaf(Q.Filter(sch.field(s[1]), FM[s[2]], s[3]))
        return (Q.and_ if s[0] == "and" else Q.or_)(
            *[build(c) for c in s[1:]])
    return build(spec).optimize()


@pytest.fixture(scope="module")
def eng():
    """BITPACK, CONST, two-group, integer-DICT and bytes-DICT columns."""
    rng = np.random.default_rng(11)
    n = PACK * P
    pack = np.arange(n) // PACK
    svals = np.array(["aa", "bb", "cc", "dd", "zz"], object)
    data = {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "a": rng.integers(0, 60_000, n, dtype=np.uint64),
        "b": rng.integers(-1 << 40, 1 << 40, n, dtype=np.int64),
        "c": np.where(pack < 2, 42, rng.integers(-1000, 1000, n)),
        "g": np.where(pack < 4, rng.integers(0, 200, n),
                      rng.integers(0, 40_000, n)).astype(np.uint64),
        "k": np.array([10, 20, 30, 4_000_000_000],
                      np.uint32)[rng.integers(0, 4, n)],
        "s": svals[rng.integers(0, 5, n)],
    }
    b = RBuilder("t").pk("id")
    for name, ft in COLS:
        b = b.add(name, RFT[ft])
    rsch = b.finish()
    rseg = r_build(rsch, data, pack_size=PACK)
    tseg = segment_from_reference(rseg)
    tsc = TScanner(TDevSeg(tseg, "cpu"))
    d = tsc.d
    assert d.column("c").groups[0].scheme == Scheme.CONST
    assert len(d.column("g").groups) == 2
    assert d.column("k").groups[0].scheme == Scheme.DICT
    assert d.column("s").groups[0].scheme == Scheme.DICT
    return rsch, tseg.schema, data, RScanner(RDevSeg(rseg)), tsc


def _same_rows(r, t, project):
    np.testing.assert_array_equal(t.row_ids, r.row_ids)
    assert t.row_ids.dtype == r.row_ids.dtype == np.uint64
    for name in project:
        assert t.rows[name].dtype == r.rows[name].dtype, name
        np.testing.assert_array_equal(t.rows[name], r.rows[name])


def _want(data, m, project, limit=0):
    rows = np.flatnonzero(m)
    if limit:
        rows = rows[:limit]
    return rows, {name: data[name][rows] for name in project}


SPECS = [
    (("leaf", "a", "RANGE", (1000, 1600)),
     lambda d: (d["a"] >= 1000) & (d["a"] <= 1600)),
    (("and", ("leaf", "s", "EQ", "zz"), ("leaf", "b", "GT", 0)),
     lambda d: (d["s"] == "zz") & (d["b"] > 0)),
    (("leaf", "a", "GT", 1 << 40), lambda d: np.zeros(len(d["a"]), bool)),
    (None, lambda d: np.ones(len(d["a"]), bool)),
]


@pytest.mark.parametrize("limit", [0, 5, 1000])
@pytest.mark.parametrize("case", range(len(SPECS)))
def test_scan_project(eng, case, limit):
    rsch, tsch, data, rsc, tsc = eng
    spec, mk = SPECS[case]
    rtree = _tree(RQ, RFM, rsch, spec) if spec else None
    ttree = _tree(TQ, TFM, tsch, spec) if spec else None
    r = rsc.scan(rtree, [RAgg("count")], project=ALL, limit=limit)
    t = tsc.scan(ttree, [TAgg("count")], project=ALL, limit=limit)
    assert t.count == r.count
    _same_rows(r, t, ALL)
    rows, vals = _want(data, mk(data), ALL, limit)
    np.testing.assert_array_equal(t.row_ids, rows.astype(np.uint64))
    for name in ALL:
        np.testing.assert_array_equal(t.rows[name], vals[name])


@pytest.mark.parametrize("batch_packs", [3, 64])
def test_scan_stream(eng, batch_packs):
    rsch, tsch, data, rsc, tsc = eng
    spec, mk = SPECS[1]
    project = ["b", "s", "g"]
    rb = list(rsc.scan_stream(_tree(RQ, RFM, rsch, spec), project,
                              batch_packs=batch_packs))
    tb = list(tsc.scan_stream(_tree(TQ, TFM, tsch, spec), project,
                              batch_packs=batch_packs))
    assert len(tb) == len(rb) == -(-P // batch_packs)
    for r, t in zip(rb, tb):
        assert t.count == r.count
        _same_rows(r, t, project)
    rows, vals = _want(data, mk(data), project)
    np.testing.assert_array_equal(
        np.concatenate([t.row_ids for t in tb]), rows.astype(np.uint64))
    for name in project:
        np.testing.assert_array_equal(
            np.concatenate([t.rows[name] for t in tb]), vals[name])


def test_unported_decode_raises(eng):
    """The pk's DELTA packs decode and project, and so do ALP packs now
    (no scheme is left that raises): an ALP group's limbs are its
    pack-relative enc, high limb first."""
    from knoxdb_tpu_torch.exec import device as TD
    _rsch, _tsch, data, rsc, tsc = eng
    assert tsc.d.column("id").groups[0].scheme == Scheme.DELTA
    r = rsc.scan(None, [RAgg("count")], project=["id"])
    t = tsc.scan(None, [TAgg("count")], project=["id"])
    _same_rows(r, t, ["id"])
    np.testing.assert_array_equal(t.rows["id"], data["id"])
    from knoxdb_tpu_torch.ops import words as WD
    planes = np.zeros((8, 1, 1), np.uint32)
    planes[0, 0, 0] = 0b1010                 # rows 1 and 3 hold enc bit 0
    planes[3, 0, 0] = 0b1000                 # row 3 holds enc bit 3
    g = TD.DeviceGroup(Scheme.ALP, 8, 0, 2, False, np.zeros(1, np.int64),
                       arrays={"planes": WD.to_words(planes, "cpu")},
                       bases=[-5], exps=[2])
    limbs = WD.from_words(TD.group_decode_limbs(g, 1))
    assert limbs.shape == (2, 1, 32) and not limbs[0].any()
    assert limbs[1, 0, :5].tolist() == [0, 1, 0, 9, 0]


def test_include_words_projection(eng, rng):
    """The join's materialization step: an include bitset of wanted
    positions, scan(None, project=) over it."""
    from knoxdb_tpu_torch.ops import bitset as TBS
    rsch, tsch, data, rsc, tsc = eng
    n = PACK * P
    pos = np.unique(rng.integers(0, n, 300))
    mm = np.zeros(n, bool)
    mm[pos] = True
    incl = TBS.np_pack_mask(mm).reshape(P, -1)
    r = rsc.scan(None, [RAgg("count")], project=["b", "c"],
                 include_words=incl)
    t = tsc.scan(None, [TAgg("count")], project=["b", "c"],
                 include_words=incl)
    _same_rows(r, t, ["b", "c"])
    np.testing.assert_array_equal(t.row_ids, pos.astype(np.uint64))
    np.testing.assert_array_equal(t.rows["b"], data["b"][pos])
