"""knoxdb_tpu_torch bit-sliced ops vs knoxdb_tpu.ops.bitslice on the same
planes: every mask word, popcount and tournament winner bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest

from knoxdb_tpu.ops import bitslice as RB
from knoxdb_tpu.types import FilterMode as RFM
from knoxdb_tpu_torch.encode.schemes import _pack_bitplanes_np
from knoxdb_tpu_torch.ops import bitset as TBS
from knoxdb_tpu_torch.ops import bitslice as TB
from knoxdb_tpu_torch.ops import words as WD
from knoxdb_tpu_torch.types import FilterMode as TFM

P, N = 8, 2048
U64_MAX = (1 << 64) - 1
WIDTHS = [1, 16, 41, 64]


def _packs(rng, width):
    """Random packs of `width`-bit values on random bases -> (planes u32
    [w, P, W], min_keys u64[P], absolute values u64[P, N])."""
    if width == 64:
        rel = rng.integers(0, U64_MAX, (P, N), dtype=np.uint64, endpoint=True)
        mk = np.zeros(P, np.uint64)
    else:
        rel = rng.integers(0, 1 << width, (P, N), dtype=np.uint64)
        mk = rng.integers(0, 1 << 40, P, dtype=np.uint64)
    planes = np.stack([_pack_bitplanes_np(rel[p], width, N)
                       for p in range(P)], axis=1)
    return planes, mk, rel + mk[:, None]


def _consts(rng, vals):
    """Compare constants: values present in the data, the extremes, and
    values outside every pack's domain."""
    picks = [int(vals[rng.integers(P), rng.integers(N)]) for _ in range(3)]
    return picks + [0, U64_MAX, int(vals.min()) - 1 if vals.min() else 1,
                    min(int(vals.max()) + 1, U64_MAX)]


def _mask(rng):
    m = (rng.integers(0, 1 << 32, (P, N // 32), dtype=np.uint64)
         .astype(np.uint32))
    m[1] = 0                                  # an empty pack
    return m


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mode", ["EQ", "NE", "LT", "LE", "GT", "GE"])
def test_cmp_planes(rng, width, mode):
    planes, mk, vals = _packs(rng, width)
    tp = WD.to_words(planes, "cpu")
    for c in _consts(rng, vals):
        want = RB.cmp_planes(RFM[mode], jnp.asarray(planes), jnp.asarray(mk),
                             jnp.uint64(c), width)
        got = TB.match_planes(TFM[mode], tp, mk, width, lo=np.uint64(c))
        np.testing.assert_array_equal(WD.from_words(got), np.asarray(want),
                                      err_msg=f"{mode} {c}")


@pytest.mark.parametrize("width", WIDTHS)
def test_range_and_in_planes(rng, width):
    planes, mk, vals = _packs(rng, width)
    tp = WD.to_words(planes, "cpu")
    cs = _consts(rng, vals)
    for lo, hi in [(cs[0], cs[1]), (cs[1], cs[0]), (cs[3], cs[4]),
                   (cs[2], cs[2]), (cs[5], cs[6])]:
        want = RB.range_planes(jnp.asarray(planes), jnp.asarray(mk),
                               jnp.uint64(lo), jnp.uint64(hi), width)
        got = TB.match_planes(TFM.RANGE, tp, mk, width, lo=np.uint64(lo),
                              hi=np.uint64(hi))
        np.testing.assert_array_equal(WD.from_words(got), np.asarray(want))
    keys = np.array(cs, np.uint64)
    for mode in ("IN", "NOT_IN"):
        want = RB.match_planes(RFM[mode], jnp.asarray(planes),
                               jnp.asarray(mk), width, cs=jnp.asarray(keys))
        got = TB.match_planes(TFM[mode], tp, mk, width, cs=keys)
        np.testing.assert_array_equal(WD.from_words(got), np.asarray(want))
    # per-pack key sets u64[K, P] (the dictionary-code form)
    kp = np.stack([vals[:, 5], vals[:, 9] + np.uint64(1)])
    want = RB.in_planes(jnp.asarray(planes), jnp.asarray(mk), jnp.asarray(kp),
                        width)
    got = TB.match_planes(TFM.IN, tp, mk, width, cs=kp)
    np.testing.assert_array_equal(WD.from_words(got), np.asarray(want))


@pytest.mark.parametrize("width", WIDTHS)
def test_masked_sum_and_tournaments(rng, width):
    planes, mk, vals = _packs(rng, width)
    tp = WD.to_words(planes, "cpu")
    mask = _mask(rng)
    tm = WD.to_words(mask, "cpu")
    sums, counts = RB.masked_sum_planes(jnp.asarray(planes), jnp.asarray(mk),
                                        jnp.asarray(mask), width)
    pcnt, tcounts = TB.masked_sum_planes(tp, tm, width)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(counts))
    pc = pcnt.numpy().astype(object)
    for p in range(P):
        s = sum(int(pc[p, b]) << b for b in range(width)) \
            + int(mk[p]) * int(tcounts[p])
        assert s % (1 << 64) == int(sums[p]), p
        # and the partials are the exact (unwrapped) masked sum
        m = TBS.np_unpack_mask(mask[p], N)
        assert s == int(vals[p][m].astype(object).sum())
    for want_max in (False, True):
        want = np.asarray(RB._tournament_planes(
            jnp.asarray(planes), jnp.asarray(mask), width, want_max))
        lo, hi = TB._tournament_planes(tp, tm, width, want_max)
        np.testing.assert_array_equal(
            WD.join_u64(WD.from_words(lo), WD.from_words(hi)), want)


def test_swar_popcount(rng):
    words = rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    words[:6] = [0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0x80000001]
    got = WD.popcount(WD.to_words(words, "cpu")).numpy()
    np.testing.assert_array_equal(got, np.bitwise_count(words))
    grid = words.reshape(64, 64)
    np.testing.assert_array_equal(
        TB.popcount_words(WD.to_words(grid, "cpu")).numpy(),
        np.asarray(RB.popcount_words(jnp.asarray(grid))))
    assert TBS.popcount(WD.to_words(grid, "cpu")) == \
        int(np.bitwise_count(words).sum())


def test_bitset_pack_roundtrip(rng):
    mask = rng.random((3, 256)) < 0.3
    import torch
    w = TBS.pack_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(
        WD.from_words(w), np.stack([TBS.np_pack_mask(m) for m in mask]))
    np.testing.assert_array_equal(TBS.unpack_mask(w).numpy(), mask)
    lo, hi = WD.split_u64(np.array([U64_MAX, 1 << 40, 7], np.uint64))
    assert WD.join_u64(lo, hi).tolist() == [U64_MAX, 1 << 40, 7]
    x = WD.to_words(np.array([0x80000000, 0xFFFFFFFF, 5], np.uint32), "cpu")
    assert WD.from_words(WD.lsr(x, 4)).tolist() == [0x08000000, 0x0FFFFFFF, 0]
