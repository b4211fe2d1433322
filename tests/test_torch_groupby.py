"""exec/groupby.py: knoxdb_tpu_torch against the knoxdb_tpu reference.

Group plans (keys and gid recipes), bucket plans, per-row group ids, the
u32 half arithmetic of the moments route, and the min/max route
group_aggregate. Tolerance 0 everywhere: keys, tags, gids in [0, G) and
every count, sum and extreme are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knoxdb_tpu.exec import device as RD
from knoxdb_tpu.exec import groupby as RGB
from knoxdb_tpu.pack.segment import build_segment as r_build
from knoxdb_tpu.schema.schema import Builder as RBuilder
from knoxdb_tpu.types import FieldType as RFT
from knoxdb_tpu_torch.exec import device as TD
from knoxdb_tpu_torch.exec import groupby as TGB
from knoxdb_tpu_torch.ops import bitset as TBS
from knoxdb_tpu_torch.ops import words as WD
from knoxdb_tpu_torch.pack.segment import segment_from_reference
from knoxdb_tpu_torch.types import FieldType as TFT

PACK = 1024


def _segs(cols, data):
    b = RBuilder("t").pk("id")
    for name, ft in cols:
        b = b.add(name, RFT[ft])
    rseg = r_build(b.finish(), data, pack_size=PACK)
    return (RD.DeviceSegment(rseg),
            TD.DeviceSegment(segment_from_reference(rseg), "cpu"))


def _gids(rdev, tdev, fname, rplan, tplan):
    rcol, tcol = rdev.column(fname), tdev.column(fname)
    r = RGB.row_gids(tuple(m[0] for m in rplan.mode),
                     tuple(g.sig() for g in rcol.groups),
                     tuple(g.idx for g in rcol.groups),
                     [g.arrays for g in rcol.groups],
                     RGB.gid_consts(rplan), rdev.W)
    t = TGB.row_gids(tuple(m[0] for m in tplan.mode), tcol.groups,
                     TGB.gid_consts(tplan, "cpu"), tdev.P, tdev.W)
    assert t.dtype == torch.int32
    return np.asarray(r), t.numpy()


def _same_plan(rplan, tplan):
    assert tplan.G == rplan.G
    assert list(tplan.keys) == list(rplan.keys)
    assert len(tplan.mode) == len(rplan.mode)
    for rm, tm in zip(rplan.mode, tplan.mode):
        assert tm[0] == rm[0]
        if tm[0] in ("lut", "const", "search"):
            np.testing.assert_array_equal(tm[1], rm[1])
        elif tm[0] == "range":
            assert tm[1] == rm[1]


@pytest.fixture(scope="module")
def keyed():
    rng = np.random.default_rng(21)
    P = 6
    n = PACK * P
    p = np.arange(n) // PACK
    sv = np.array(["ant", "bee", "cat", "dog", "emu", "fox", "gnu"], object)
    data = {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "d": (5 + rng.integers(0, 300, n)).astype(np.uint32),
        "sp": (rng.integers(0, 1000, n) * 13).astype(np.uint64),
        "k": np.array([10, 20, 30, 40, 5_000_000_000],
                      np.uint64)[rng.integers(0, 5, n)],
        "s": sv[rng.integers(0, 7, n)],
        "c": np.where(p < 2, -7, rng.integers(-100, 100, n)),
        "neg": rng.integers(-500, 500, n),
    }
    cols = [("d", "UINT32"), ("sp", "UINT64"), ("k", "UINT64"),
            ("s", "STRING"), ("c", "INT64"), ("neg", "INT32")]
    return _segs(cols, data), data


@pytest.mark.parametrize("fname,tags,global_keys", [
    ("d", {"range"}, False),
    ("sp", {"search"}, True),         # a sparse domain given by the caller
    ("sp", {"range"}, False),
    ("k", {"lut"}, False),
    ("s", {"lut"}, False),
    ("c", {"const", "range"}, False),
    ("neg", {"range"}, False),
])
def test_plan_groups_and_row_gids(keyed, fname, tags, global_keys):
    (rdev, tdev), data = keyed
    gk = None
    if global_keys:
        gk = np.unique(data[fname]).astype(np.uint64)
    rplan = RGB.plan_groups(rdev, fname, gk)
    tplan = TGB.plan_groups(tdev, fname, gk)
    _same_plan(rplan, tplan)
    assert {m[0] for m in tplan.mode} == tags
    if gk is None:
        assert list(TGB.segment_group_keys(tdev, fname)) == \
            list(RGB.segment_group_keys(rdev, fname))
    ft = tdev.seg.columns[fname].field.type
    np.testing.assert_array_equal(
        tplan.key_values(ft), rplan.key_values(RFT(int(ft))))
    r, t = _gids(rdev, tdev, fname, rplan, tplan)
    np.testing.assert_array_equal(t, r)
    n = len(data[fname])
    got = t.reshape(-1)[:n]
    assert ((got >= 0) & (got < tplan.G)).all()
    vals = tplan.key_values(ft)
    np.testing.assert_array_equal(vals[got], data[fname])


def test_plan_groups_limits(keyed):
    (_rdev, tdev), _data = keyed
    with pytest.raises(ValueError, match="MAX_GROUPS"):
        TGB.plan_groups(tdev, "d",
                        np.arange(TGB.MAX_GROUPS + 1, dtype=np.uint64))


@pytest.mark.parametrize("iv,want_tag", [(64, "bucket32s:6"),
                                         (100, "bucket32"),
                                         (1 << 40, "bucket")])
def test_plan_buckets_row_gids(iv, want_tag):
    """As tests/test_groupby.py::test_bucket32_gid_paths: rows below t0
    -> -1, rows past the last bucket -> a gid >= G, the rest exact."""
    rng = np.random.default_rng(0xC0FFEE + iv)
    n, t0, G = 4096, 1_000_000, 64
    span = G * iv
    ts = (t0 - 500 + rng.integers(0, span + 3000, n)).astype(np.uint64)
    rdev, tdev = _segs([("ts", "UINT64")],
                       {"id": np.arange(1, n + 1, dtype=np.uint64),
                        "ts": ts})
    rplan = RGB.plan_buckets(rdev, "ts", t0, iv, G)
    tplan = TGB.plan_buckets(tdev, "ts", t0, iv, G)
    assert tplan.mode[0][0] == rplan.mode[0][0] == want_tag
    assert list(tplan.keys) == list(rplan.keys)
    r, t = _gids(rdev, tdev, "ts", rplan, tplan)
    r, t = r.reshape(-1)[:n], t.reshape(-1)[:n]
    inr = (ts >= t0) & (ts < t0 + span)
    want = ((ts - np.uint64(t0)) // np.uint64(iv)).astype(np.int64)
    np.testing.assert_array_equal(t[inr], want[inr])
    np.testing.assert_array_equal(t[inr], r[inr])
    assert (t[ts < t0] == -1).all() and (r[ts < t0] == -1).all()
    assert (t[ts >= t0 + span] >= G).all()


def test_bucket_gids_at_the_u64_edges():
    """The "bucket" route takes keys near 0 and 2^64 - 1 without
    overflow: buckets whose start passes 2^64 simply do not exist."""
    t0, iv, G = (1 << 64) - (5 << 40), 1 << 40, 8
    ts = np.array([0, t0 - 1, t0, t0 + iv, (1 << 64) - 1, t0 + 3 * iv + 7],
                  np.uint64)
    ts = np.resize(ts, 64)
    _rdev, tdev = _segs([("ts", "UINT64")],
                        {"id": np.arange(1, 65, dtype=np.uint64), "ts": ts})
    tplan = TGB.plan_buckets(tdev, "ts", t0, iv, G)
    assert tplan.mode[0][0] == "bucket"
    t = TGB.row_gids(("bucket",), tdev.column("ts").groups,
                     TGB.gid_consts(tplan, "cpu"), tdev.P, tdev.W)
    got = t.numpy().reshape(-1)[:6].tolist()
    assert got == [-1, -1, 0, 1, 4, 3]


_EDGE_U32 = np.array([0, 1, 0x7FFF, 0x8000, 0xFFFF, 0x10000, 0x7FFFFFFF,
                      0x80000000, 0xFFFEFFFF, 0xFFFFFFFF], np.uint32)


def test_square_halves():
    rng = np.random.default_rng(3)
    r = np.concatenate([_EDGE_U32, rng.integers(0, 1 << 32, 4000,
                                                dtype=np.uint64)
                        .astype(np.uint32)])
    rlo, rhi = RGB.square_halves(jnp.asarray(r))
    tlo, thi = TGB.square_halves(WD.to_words(r, "cpu"))
    np.testing.assert_array_equal(WD.from_words(tlo), np.asarray(rlo))
    np.testing.assert_array_equal(WD.from_words(thi), np.asarray(rhi))
    sq = WD.join_u64(WD.from_words(tlo), WD.from_words(thi))
    assert [int(x) for x in sq] == [int(x) ** 2 for x in r]


@pytest.mark.parametrize("bias", [0, 1, 0xFFFFFFFF, 1 << 32, (1 << 63) - 5,
                                  (1 << 64) - 1])
def test_value_halves(bias):
    rng = np.random.default_rng(bias % 1000)
    v = rng.integers(0, 1 << 64, 3000, dtype=np.uint64)
    v[:len(_EDGE_U32)] = _EDGE_U32
    v[-4:] = [0, bias, (1 << 64) - 1, (bias + 1) % (1 << 64)]
    lo, hi = WD.split_u64(v)
    rlo, rhi = RGB._value_halves((jnp.asarray(lo), jnp.asarray(hi)),
                                 jnp.uint64(bias))
    tlo, thi = TGB._value_halves((WD.to_words(lo, "cpu"),
                                  WD.to_words(hi, "cpu")), bias)
    np.testing.assert_array_equal(WD.from_words(tlo), np.asarray(rlo))
    np.testing.assert_array_equal(WD.from_words(thi), np.asarray(rhi))
    got = WD.join_u64(WD.from_words(tlo), WD.from_words(thi))
    np.testing.assert_array_equal(got, v - np.uint64(bias))


def test_chunk_plan(keyed):
    (rdev, tdev), _data = keyed
    for f in ("d", "sp", "k", "c", "neg"):
        assert TGB.chunk_plan(tdev.seg.stats.fields[f]) == \
            RGB.chunk_plan(rdev.seg.stats.fields[f])
    assert TGB.chunk_plan(None) == (8, 0)


@pytest.mark.parametrize("G", [1, 37, 1000])
def test_group_aggregate(G):
    """The min/max route against the reference's sort-based
    group_aggregate: counts, split sums, extremes; empty groups at
    (u64 max, 0)."""
    rng = np.random.default_rng(G)
    P, N = 3, 4096
    gids = rng.integers(-2, G + 3, (P, N)).astype(np.int32)
    vals = rng.integers(0, 1 << 64, (P, N), dtype=np.uint64)
    vals[0, :8] = np.uint64(0xFFFFFFFFFFFFFFFF)
    vals[1, :8] = 0
    vals[2, :8] = np.uint64(1 << 63)
    maskb = rng.random((P, N)) < 0.6
    words = np.stack([TBS.np_pack_mask(maskb[p]) for p in range(P)])
    want = RGB.group_aggregate(jnp.asarray(gids), jnp.asarray(words),
                               jnp.asarray(vals), G)
    got = TGB.group_aggregate(torch.from_numpy(gids),
                              WD.to_words(words, "cpu"),
                              torch.from_numpy(WD.ordered_from_u64(vals)),
                              G)
    c, s_lo, s_hi, mn, mx = (t.numpy() for t in got)
    np.testing.assert_array_equal(c, np.asarray(want[0]))
    np.testing.assert_array_equal(s_lo.astype(np.uint64), np.asarray(want[1]))
    np.testing.assert_array_equal(s_hi.astype(np.uint64), np.asarray(want[2]))
    np.testing.assert_array_equal(WD.u64_from_ordered(mn), np.asarray(want[3]))
    np.testing.assert_array_equal(WD.u64_from_ordered(mx), np.asarray(want[4]))


def test_key_values_types():
    """GroupPlan.key_values maps keyform keys back to native values for
    signed, unsigned and string keys, as the reference does."""
    keys = np.array([0, 1 << 31, (1 << 32) - 1], np.uint64)
    for ft in (TFT.INT32, TFT.UINT32, TFT.INT64, TFT.UINT64):
        tp = TGB.GroupPlan(keys, 3, [])
        rp = RGB.GroupPlan(keys, 3, [])
        np.testing.assert_array_equal(tp.key_values(ft),
                                      rp.key_values(RFT(int(ft))))
    assert list(TGB.GroupPlan(np.array([b"a", b"b"], object), 2, [])
                .key_values(TFT.STRING)) == ["a", "b"]


def test_bucket_gids_past_2_31_buckets():
    """A row 2^32 or more buckets past t0 lands at a gid >= G. (The
    reference's "bucket" route casts the u64 quotient to int32, which
    wraps such a row into [0, G): ROADMAP.md section 3.)"""
    ts = np.resize(np.array([0, 5, 1 << 31, 1 << 63, (1 << 63) + 7,
                             (1 << 64) - 1], np.uint64), 64)
    _rdev, tdev = _segs([("ts", "UINT64")],
                        {"id": np.arange(1, 65, dtype=np.uint64), "ts": ts})
    tplan = TGB.plan_buckets(tdev, "ts", 0, 1 << 31, 1)
    assert tplan.mode[0][0] == "bucket"
    t = TGB.row_gids(("bucket",), tdev.column("ts").groups,
                     TGB.gid_consts(tplan, "cpu"), tdev.P, tdev.W)
    assert t.numpy().reshape(-1)[:6].tolist() == [0, 0, 1, 1, 1, 1]
