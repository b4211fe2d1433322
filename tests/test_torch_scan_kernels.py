"""knoxdb_tpu_torch scan kernels (their plain PyTorch versions, as the CPU
runs them) vs the knoxdb_tpu Pallas kernels in interpret mode: every
output word bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest

from knoxdb_tpu.encode import schemes as RS
from knoxdb_tpu.ops import pallas_scan as PS
from knoxdb_tpu_torch.ops import scan_kernels as SK
from knoxdb_tpu_torch.ops import words as WD
from knoxdb_tpu_torch.testing import random_tree_case

U64_MAX = (1 << 64) - 1


def _words(a):
    return WD.to_words(np.asarray(a), "cpu")


def _eq(got, want, what=""):
    """int32-carried port output == 32-bit reference output, bitwise."""
    np.testing.assert_array_equal(WD.from_words(got),
                                  np.asarray(want).view(np.uint32),
                                  err_msg=what)


@pytest.mark.parametrize("width", [0, 1, 16, 41, 64])
def test_range_consts(rng, width):
    P = 16
    mins = rng.integers(0, 1 << 40, P, dtype=np.uint64)
    mins[0] = 0
    span = 1 << min(width, 40)
    for lo, hi in [(0, U64_MAX), (int(mins[3]), int(mins[3]) + span // 2),
                   (U64_MAX, U64_MAX), (1, 0), (int(mins[5]) + span, 1 << 41)]:
        want = PS.range_consts(jnp.asarray(mins), jnp.uint64(lo),
                               jnp.uint64(hi), width)
        got = SK.range_consts(mins, np.uint64(lo), np.uint64(hi), width)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    # per-pack bounds (the dictionary code-range form)
    lo_a = rng.integers(0, 8, P, dtype=np.uint64)
    hi_a = lo_a + rng.integers(0, 8, P, dtype=np.uint64)
    want = PS.range_consts(jnp.zeros(P, jnp.uint64), jnp.asarray(lo_a),
                           jnp.asarray(hi_a), width)
    got = SK.range_consts(np.zeros(P, np.uint64), lo_a, hi_a, width)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("width,P", [(8, 8), (16, 8), (1, 16), (41, 8)])
def test_fused_range_sum_masked(rng, width, P):
    N = 2048
    vals = rng.integers(0, 1 << width, (P, N), dtype=np.uint64)
    mins = rng.integers(0, 500, P, dtype=np.uint64)
    planes = np.stack([
        RS.encode_bitpack(vals[p] + mins[p], 1, int(mins[p]), width,
                          N).planes for p in range(P)], axis=1)
    valid = np.full((P, N // 32), 0xFFFFFFFF, np.uint32)
    valid[-1, -2:] = 0x0000FFFF      # partial pack edge
    valid[-1, -1] = 0
    for lo, hi in [(400, 900), (0, 10**6), (10**6, 2 * 10**6), (550, 550)]:
        lob, hib, flags = SK.range_consts(mins, np.uint64(lo), np.uint64(hi),
                                          width)
        before = SK.PLAIN_CALLS["fused_range_sum_masked"]
        got = SK.fused_range_sum(_words(planes), _words(lob), _words(hib),
                                 _words(flags), _words(valid), width)
        assert SK.PLAIN_CALLS["fused_range_sum_masked"] == before + 1
        want = PS.fused_range_sum_masked(
            jnp.asarray(planes), jnp.asarray(lob), jnp.asarray(hib),
            jnp.asarray(flags), jnp.asarray(valid), width, interpret=True)
        for g, w, name in zip(got, want, ("mask", "pcnt", "cnt")):
            _eq(g, w, f"[{lo},{hi}] {name}")
        ref = SK.fused_range_sum_ref(_words(planes), mins, _words(valid),
                                     np.uint64(lo), np.uint64(hi), width)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and bool((g == r).all())


_TREE_CASES = [
    # (fwidths, nleaf, agg_specs)
    ((16,), 1, ((0, True, True),)),
    ((41, 16), 2, ((0, True, False), (1, False, True))),
    ((64, 1, 12), 3, ((0, True, True), (1, True, True), (2, False, True))),
    ((32, 8), 2, ()),                                  # mask-only
    ((48,), 0, ((0, True, True),)),                    # aggregates only
]


@pytest.mark.parametrize("fwidths,nleaf,specs", _TREE_CASES)
def test_fused_tree_agg(rng, fwidths, nleaf, specs):
    P, W = 8, 64
    case = random_tree_case(rng, fwidths, P, W, nleaf, specs)
    planes, leaf_ops, leaf_field, mask_in, fw, sp = case
    before = SK.PLAIN_CALLS["fused_tree_agg"]
    mask, cnt, parts = SK.fused_tree_agg(
        [_words(p) for p in planes],
        [tuple(_words(a) for a in op) for op in leaf_ops], leaf_field,
        _words(mask_in), fw, sp)
    assert SK.PLAIN_CALLS["fused_tree_agg"] == before + 1
    rmask, rcnt, rparts = PS.fused_tree_agg(
        [jnp.asarray(p) for p in planes],
        [tuple(jnp.asarray(a) for a in op) for op in leaf_ops], leaf_field,
        jnp.asarray(mask_in), fw, sp, interpret=True)
    _eq(mask, rmask, "mask")
    _eq(cnt, rcnt, "cnt")
    assert int(cnt[-1]) == 0                            # the empty pack
    assert len(parts) == len(rparts)
    for d, rd in zip(parts, rparts):
        assert sorted(d) == sorted(rd)
        for k in d:
            _eq(d[k], rd[k], k)
        if "mnmx" in d:
            assert not d["mnmx"][:, 4:].any()
    # the thin sum wrapper is the same kernel
    if specs and specs[0][1]:
        m2, pc2, c2 = SK.fused_tree_sum(
            [_words(p) for p in planes],
            [tuple(_words(a) for a in op) for op in leaf_ops], leaf_field,
            _words(mask_in), fw, specs[0][0])
        assert bool((pc2 == parts[0]["pcnt"]).all() and (c2 == cnt).all())


def test_width_zero_field(rng):
    """A width-0 field (every value equals its pack's min_key): the Pallas
    kernels cannot take a block of 0 planes, so the port's kernel is held
    against the reference's XLA composition fused_range_sum_ref, and its
    tournament words must be 0 and its pcnt one zero column."""
    P, W = 8, 64
    mins = rng.integers(0, 1000, P, dtype=np.uint64)
    planes = np.zeros((1, P, W), np.uint32)
    mask_in = rng.integers(0, 1 << 32, (P, W), dtype=np.uint64) \
        .astype(np.uint32)
    mask_in[-1] = 0
    for lo, hi in [(0, U64_MAX), (int(mins[2]), int(mins[2])), (2000, 3000)]:
        ops = SK.range_consts(mins, np.uint64(lo), np.uint64(hi), 0)
        mask, cnt, parts = SK.fused_tree_agg(
            [_words(planes)], [tuple(_words(a) for a in ops)], (0,),
            _words(mask_in), (0,), ((0, True, True),))
        rmask, rpcnt, rcnt = PS.fused_range_sum_ref(
            jnp.asarray(planes), jnp.asarray(mins), jnp.asarray(mask_in),
            jnp.uint64(lo), jnp.uint64(hi), 0)
        _eq(mask, rmask, "mask")
        # the XLA composition sums its counts in int64
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(rcnt))
        np.testing.assert_array_equal(parts[0]["pcnt"].numpy(),
                                      np.asarray(rpcnt))
        assert parts[0]["pcnt"].shape == (P, 1)
        assert not parts[0]["mnmx"].any()
