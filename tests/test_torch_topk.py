"""Ordered top-k: ops/bitslice.add_const_planes and topk_select, and
exec/sort.segment_topk on both routes (the bit descent over BITPACK order
columns, narrow, wide and in several groups; the stable-sort fallback over
DELTA, RLE and mixed wide columns), ascending and descending, with k above
the match count and with ties across the k-th place.

Against knoxdb_tpu on the same inputs, tolerance 0: planes, masks and
threshold words bit for bit; segment_topk's keys, row positions (`__idx`)
and projected limbs equal, and the keys equal to a sorted python oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knoxdb_tpu.exec import sort as RSort
from knoxdb_tpu.exec.device import DeviceSegment as RDevSeg
from knoxdb_tpu.exec.scan import SegmentScanner as RScanner
from knoxdb_tpu.ops import bitslice as RB
from knoxdb_tpu.pack.segment import build_segment as r_build
from knoxdb_tpu.query import filter as RQ
from knoxdb_tpu.schema.schema import Builder as RBuilder
from knoxdb_tpu.types import FieldType as RFT
from knoxdb_tpu.types import FilterMode as RFM
from knoxdb_tpu_torch.encode.schemes import Scheme
from knoxdb_tpu_torch.exec import sort as TSort
from knoxdb_tpu_torch.exec.device import DeviceSegment as TDevSeg
from knoxdb_tpu_torch.exec.scan import SegmentScanner as TScanner
from knoxdb_tpu_torch.ops import bitslice as TB
from knoxdb_tpu_torch.ops import words as WD
from knoxdb_tpu_torch.pack.segment import segment_from_reference
from knoxdb_tpu_torch.query import filter as TQ
from knoxdb_tpu_torch.types import FilterMode as TFM
from torch_mixed import Mixed

PP, WW = 5, 8          # packs and words per pack of the plane-level cases


def _rand_u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _w(a):
    return WD.to_words(a, "cpu")


@pytest.mark.parametrize("w,wo", [(1, 1), (2, 5), (16, 17), (64, 80),
                                  (63, 63), (40, 272)])
def test_add_const_planes(rng, w, wo):
    planes = _rand_u32(rng, (w, PP, WW))
    cb = np.where(rng.random((wo, PP)) < 0.5, 0xFFFFFFFF, 0).astype(np.uint32)
    got = TB.add_const_planes(_w(planes), _w(cb), wo)
    want = RB.add_const_planes(jnp.asarray(planes), jnp.asarray(cb), wo)
    np.testing.assert_array_equal(WD.from_words(got), np.asarray(want))


def _plane_values(planes):
    """u32[w, P, W] planes -> python-int values [P * W * 32]."""
    w = planes.shape[0]
    bits = np.unpackbits(planes.view(np.uint8).reshape(w, -1, 4),
                         axis=-1, bitorder="little").reshape(w, -1)
    vals = np.zeros(bits.shape[1], object)
    for p in range(w):
        vals = vals + (bits[p].astype(object) << p)
    return vals


@pytest.mark.parametrize("want_max", [False, True])
@pytest.mark.parametrize("width", [1, 2, 63, 64, 127])
def test_topk_select(rng, width, want_max):
    planes = _rand_u32(rng, (width, PP, WW))
    if width > 2:
        planes[2:] &= planes[2:3]        # many equal keys: ties at the cut
    mask = _rand_u32(rng, (PP, WW)) | _rand_u32(rng, (PP, WW))
    mask[-1] = 0
    vals = _plane_values(planes)
    mbits = np.unpackbits(mask.view(np.uint8), bitorder="little") \
        .astype(bool)
    nmatch = int(mbits.sum())
    for k in (1, 7, nmatch // 2, nmatch, nmatch + 5):
        tw, better, tie, nb = TB.topk_select(_w(planes), _w(mask), k, width,
                                             want_max)
        rtw, rbetter, rtie, rnb = RB.topk_select(
            jnp.asarray(planes), jnp.asarray(mask), jnp.int32(k), width,
            want_max)
        np.testing.assert_array_equal(WD.from_words(better),
                                      np.asarray(rbetter))
        np.testing.assert_array_equal(WD.from_words(tie), np.asarray(rtie))
        assert int(nb) == int(rnb)
        assert [int(t) & 0xFFFFFFFF for t in tw] == [int(t) for t in rtw]
        # the oracle: the k-th key is the threshold whenever k rows match
        if k <= nmatch:
            kth = sorted(vals[mbits].tolist(), reverse=want_max)[k - 1]
            T = sum((int(t) & 0xFFFFFFFF) << (32 * j)
                    for j, t in enumerate(tw))
            assert T == kth
            bbits = np.unpackbits(WD.from_words(better).view(np.uint8),
                                  bitorder="little").astype(bool)
            beat = (vals > kth) if want_max else (vals < kth)
            np.testing.assert_array_equal(bbits, mbits & beat)


def test_topk_select_takes_a_device_k(rng):
    planes = _rand_u32(rng, (9, PP, WW))
    mask = _rand_u32(rng, (PP, WW))
    a = TB.topk_select(_w(planes), _w(mask), 11, 9, True)
    b = TB.topk_select(_w(planes), _w(mask), torch.tensor(11), 9, True)
    assert all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))


# ----------------------------------------------------------- segment_topk --

PACK, P = 1024, 4
BIG0 = (1 << 90) + 7


def _cfg4_like():
    """The shape of BASELINE config #4: id pk (DELTA), val u64 (one
    BITPACK group), big INT128 whose every pack is wide BITPACK, and dup, a
    BITPACK column of few distinct values."""
    rng = np.random.default_rng(4)
    n = PACK * P
    data = {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "val": rng.integers(0, 1 << 16, n, dtype=np.uint64),
        "dup": rng.integers(0, 900, n, dtype=np.uint64),
        "big": np.array([BIG0 + ((i // PACK) << 42)
                         + int(rng.integers(0, 1 << 40))
                         for i in range(n)], object),
    }
    b = RBuilder("c4").pk("id").add("val", RFT.UINT64) \
        .add("dup", RFT.UINT64).add("big", RFT.INT128)
    rsch = b.finish()
    rseg = r_build(rsch, data, pack_size=PACK)
    tseg = segment_from_reference(rseg)
    return (data, rsch, tseg.schema, RScanner(RDevSeg(rseg)),
            TScanner(TDevSeg(tseg, "cpu")))


@pytest.fixture(scope="module")
def c4():
    return _cfg4_like()


@pytest.fixture(scope="module")
def mx():
    m = Mixed()
    m.check_schemes()
    return m


def _topk_both(rsc, tsc, rtree, ttree, field, k, desc, project):
    r = RSort.segment_topk(rsc, rtree, field, k, desc=desc, project=project)
    t = TSort.segment_topk(tsc, ttree, field, k, desc=desc, project=project)
    rkeys, rrows, rn = r
    tkeys, trows, tn = t
    assert tn == rn and tkeys == [int(x) for x in rkeys]
    assert sorted(trows) == sorted(rrows)
    for name in rrows:
        np.testing.assert_array_equal(np.asarray(trows[name]),
                                      np.asarray(rrows[name]), err_msg=name)
    return t


def _keyform(col, ft_bits, signed):
    bias = (1 << (ft_bits - 1)) if signed else 0
    return [int(v) + bias for v in col]


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("field,k", [("val", 100), ("big", 100),
                                     ("dup", 37), ("val", 1)])
def test_topk_bit_descent(c4, field, k, desc):
    data, rsch, tsch, rsc, tsc = c4
    assert TSort._topk_fast_plan(tsc.d, tsc.d.seg.columns[field],
                                 field) is not None
    rtree = RQ.leaf(RQ.Filter(rsch.field("val"), RFM.LT, 50000)).optimize()
    ttree = TQ.leaf(TQ.Filter(tsch.field("val"), TFM.LT, 50000)).optimize()
    keys, rows, n = _topk_both(rsc, tsc, rtree, ttree, field, k, desc,
                               ["id", "val"])
    m = data["val"] < 50000
    kf = _keyform(data[field], 128, field == "big")
    want = sorted((kf[i] for i in np.flatnonzero(m)), reverse=desc)[:k]
    assert keys == want and n == k
    # each returned row holds its key, and passes the filter
    idx = rows["__idx"]
    assert [kf[i] for i in idx] == keys and m[idx].all()
    np.testing.assert_array_equal(rows["id"][-1], data["id"][idx] & 0xFFFFFFFF)


def test_fast_plan_const_bits(c4):
    """The vectorized plan gives the reference's per-pack constant bits."""
    data, _rsch, _tsch, rsc, tsc = c4
    for field in ("val", "big", "dup"):
        rwo, rcb, rgmin = RSort._topk_fast_plan(
            rsc.d, rsc.d.seg.columns[field], field)
        two, tcb, tgmin = TSort._topk_fast_plan(
            tsc.d, tsc.d.seg.columns[field], field)
        assert (two, tgmin) == (rwo, rgmin)
        np.testing.assert_array_equal(tcb, rcb)


def test_topk_multi_group_order_column(mx):
    """The two-width-group BITPACK column, with ties across the k-th place
    (values below 200 repeat about 15 times in packs 0-2)."""
    assert len(mx.tsc.d.column("a").groups) == 2
    for desc, k in ((False, 50), (True, 20), (False, 1000)):
        keys, rows, n = _topk_both(mx.rsc, mx.tsc, None, None, "a", k, desc,
                                   ["id", "big"])
        want = sorted((int(v) for v in mx.data["a"]), reverse=desc)[:k]
        assert keys == want


def test_topk_k_above_matches(c4, mx):
    data, rsch, tsch, rsc, tsc = c4
    rtree = RQ.leaf(RQ.Filter(rsch.field("val"), RFM.LT, 40)).optimize()
    ttree = TQ.leaf(TQ.Filter(tsch.field("val"), TFM.LT, 40)).optimize()
    nmatch = int((data["val"] < 40).sum())
    assert 0 < nmatch < 100
    keys, rows, n = _topk_both(rsc, tsc, rtree, ttree, "val", 100, True,
                               ["id", "big"])
    assert n == nmatch == len(keys) == len(rows["__idx"])
    # the fallback route, and a filter that matches nothing
    rtree, ttree = mx.trees(("leaf", "a", "GT", 39_900))
    nmatch = int((mx.data["a"] > 39_900).sum())
    keys, rows, n = _topk_both(mx.rsc, mx.tsc, rtree, ttree, "id", 64, False,
                               ["d"])
    assert n == nmatch < 64
    rtree, ttree = mx.trees(("leaf", "a", "GT", 1 << 40))
    for field in ("id", "a", "big"):
        keys, rows, n = _topk_both(mx.rsc, mx.tsc, rtree, ttree, field, 8,
                                   False, [])
        assert (keys, n) == ([], 0)


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("field", ["id", "d", "r", "w", "k", "big", "h"])
def test_topk_fallback(mx, field, desc):
    """Order columns that are not all BITPACK: the narrow stable sort
    (DELTA, RLE with whole runs of equal keys across the k-th place, RAW,
    DICT) and the wide LSB-first passes (INT128, INT256)."""
    tsc = mx.tsc
    assert TSort._topk_fast_plan(tsc.d, tsc.d.seg.columns[field],
                                 field) is None
    assert any(g.scheme != Scheme.BITPACK
               for g in tsc.d.column(field).groups)
    rtree, ttree = mx.trees(("leaf", "a", "GE", 3))
    keys, rows, n = _topk_both(mx.rsc, mx.tsc, rtree, ttree, field, 45, desc,
                               ["id", "a", "big"])
    m = mx.data["a"] >= 3
    ft = tsc.d.seg.columns[field].field.type
    kf = _keyform(mx.data[field], ft.bits, ft.is_signed)
    want = sorted((kf[i] for i in np.flatnonzero(m)), reverse=desc)[:45]
    assert keys == want and n == 45
    assert [kf[i] for i in rows["__idx"]] == keys
