"""The split scan kernels of knoxdb_tpu_torch/ops/scan_kernels.py
(range_mask_count, masked_plane_popcounts; on the CPU their plain PyTorch
versions) against the probe's Pallas bodies k_ladder_only and k_pcnt_only
of probes/ps_variants.py in interpret mode, and against the reference's
composition fused_range_sum_ref, at both plane layouts: plane-major
[w, P, W], and the permuted view of a pack-major tensor [P, w, W], which
the wrappers take without a copy.

Words and counts are integers: tolerance 0."""

import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from knoxdb_tpu.ops import pallas_scan as PS
from knoxdb_tpu_torch.ops import scan_kernels as SK
from knoxdb_tpu_torch.ops import words as WD
from knoxdb_tpu_torch.testing import (misaligned_copy, random_tree_case,
                                      split_layouts, split_masks)

_spec = importlib.util.spec_from_file_location(
    "ps_variants", Path(__file__).resolve().parents[1] / "probes"
    / "ps_variants.py")
PV = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(PV)

P, W, T = 16, 64, 8
_Z = np.int32(0)


def _row(*shape):
    return pl.BlockSpec(shape, lambda i: (i,) + (_Z,) * (len(shape) - 1))


def _probe_ladder(w, lo, hi, fl, planes_pk, valid):
    """ps_variants.build(..., k_ladder_only, nouts=2) in interpret mode,
    on pack-major planes [P, w, W]."""
    w1 = max(w, 1)
    return pl.pallas_call(
        partial(PV.k_ladder_only, width=w), grid=(P // T,),
        in_specs=[_row(T, w1), _row(T, w1), _row(T, PS._NFLAGS),
                  _row(T, w1, W), _row(T, W)],
        out_specs=[_row(T, W), _row(T, 1)],
        out_shape=[jax.ShapeDtypeStruct((P, W), jnp.uint32),
                   jax.ShapeDtypeStruct((P, 1), jnp.int32)],
        interpret=True)(lo, hi, fl, planes_pk, valid)


def _probe_pcnt(w, planes_pk, mask):
    """ps_variants.build_pcnt in interpret mode."""
    w1 = max(w, 1)
    return pl.pallas_call(
        partial(PV.k_pcnt_only, width=w), grid=(P // T,),
        in_specs=[_row(T, w1, W), _row(T, W)],
        out_specs=[_row(T, w1), _row(T, 1)],
        out_shape=[jax.ShapeDtypeStruct((P, w1), jnp.int32),
                   jax.ShapeDtypeStruct((P, 1), jnp.int32)],
        interpret=True)(planes_pk, mask)


def _case(rng, width, mask="random"):
    planes, ops, _lf, mask_in, _fw, _sp = random_tree_case(
        rng, (width,), P, W, 1, (), empty_pack=(mask == "random"))
    if mask == "empty":
        mask_in[:] = 0
    elif mask == "full":
        mask_in[:] = 0xFFFFFFFF
    pk = np.ascontiguousarray(planes[0].transpose(1, 0, 2))   # [P, w1, W]
    return planes[0], pk, ops[0], mask_in


def _layouts(planes_pm, planes_pk):
    """The same planes as the plane-major tensor and as the permuted view
    of the pack-major one."""
    view = WD.to_words(planes_pk, "cpu").permute(1, 0, 2)
    assert view.shape == planes_pm.shape
    return {"plane-major": WD.to_words(planes_pm, "cpu"), "pack-major": view}


@pytest.mark.parametrize("mask", ["random", "empty", "full"])
@pytest.mark.parametrize("width", [1, 16, 33, 64])
def test_range_mask_count(rng, width, mask):
    planes_pm, planes_pk, (lo, hi, fl), mask_in = _case(rng, width, mask)
    rmask, rcnt = _probe_ladder(width, jnp.asarray(lo), jnp.asarray(hi),
                                jnp.asarray(fl), jnp.asarray(planes_pk),
                                jnp.asarray(mask_in))
    for name, pt in _layouts(planes_pm, planes_pk).items():
        before = SK.PLAIN_CALLS["range_mask_count"]
        got, cnt = SK.range_mask_count(
            pt, *(WD.to_words(a, "cpu") for a in (lo, hi, fl)),
            WD.to_words(mask_in, "cpu"), width)
        assert SK.PLAIN_CALLS["range_mask_count"] == before + 1
        assert cnt.dtype == torch.int64 and cnt.shape == (P,)
        np.testing.assert_array_equal(WD.from_words(got), np.asarray(rmask),
                                      err_msg=name)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(rcnt)[:, 0],
                                      err_msg=name)
    if mask == "full":       # no incoming mask means every row
        none = SK.range_mask_count(
            WD.to_words(planes_pm, "cpu"),
            *(WD.to_words(a, "cpu") for a in (lo, hi, fl)), None, width)
        assert torch.equal(none[0], got) and torch.equal(none[1], cnt)


@pytest.mark.parametrize("mask", ["random", "empty", "full"])
@pytest.mark.parametrize("width", [1, 16, 33, 64])
def test_masked_plane_popcounts(rng, width, mask):
    planes_pm, planes_pk, _ops, mask_in = _case(rng, width, mask)
    rpcnt, rcnt = _probe_pcnt(width, jnp.asarray(planes_pk),
                              jnp.asarray(mask_in))
    for name, pt in _layouts(planes_pm, planes_pk).items():
        before = SK.PLAIN_CALLS["masked_plane_popcounts"]
        pcnt, cnt = SK.masked_plane_popcounts(
            pt, WD.to_words(mask_in, "cpu"), width)
        assert SK.PLAIN_CALLS["masked_plane_popcounts"] == before + 1
        assert pcnt.dtype == cnt.dtype == torch.int64
        np.testing.assert_array_equal(pcnt.numpy(), np.asarray(rpcnt),
                                      err_msg=name)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(rcnt)[:, 0],
                                      err_msg=name)


@pytest.mark.parametrize("width", [0, 1, 16, 41, 64])
def test_split_pair_equals_fused_range_sum_ref(rng, width):
    """range_mask_count then masked_plane_popcounts = the reference's
    composition of the one-leaf kernel (width 0 included, which the Pallas
    bodies cannot take), and = the port's own fused wrapper at the
    pack-major view."""
    mins = rng.integers(0, 500, P, dtype=np.uint64)
    planes = rng.integers(0, 1 << 32, (max(width, 1), P, W),
                          dtype=np.uint64).astype(np.uint32)
    if width == 0:
        planes[:] = 0
    valid = rng.integers(0, 1 << 32, (P, W), dtype=np.uint64) \
        .astype(np.uint32)
    span = 1 << min(width, 40)
    for lo, hi in [(100, 100 + span // 2), (0, (1 << 64) - 1), (1, 0),
                   (int(mins[2]), int(mins[2]))]:
        ops = [WD.to_words(a, "cpu") for a in SK.range_consts(
            mins, np.uint64(lo), np.uint64(hi), width)]
        pt = WD.to_words(planes, "cpu")
        pk_view = pt.permute(1, 0, 2).contiguous().permute(1, 0, 2)
        vt = WD.to_words(valid, "cpu")
        mask, cnt = SK.range_mask_count(pk_view, *ops, vt, width)
        pcnt, cnt2 = SK.masked_plane_popcounts(pk_view, mask, width)
        rmask, rpcnt, rcnt = PS.fused_range_sum_ref(
            jnp.asarray(planes), jnp.asarray(mins), jnp.asarray(valid),
            jnp.uint64(lo), jnp.uint64(hi), width)
        np.testing.assert_array_equal(WD.from_words(mask), np.asarray(rmask))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(rcnt))
        np.testing.assert_array_equal(cnt2.numpy(), np.asarray(rcnt))
        np.testing.assert_array_equal(pcnt.numpy(), np.asarray(rpcnt))
        fm, fp, fc = SK.fused_range_sum_masked(pk_view, *ops, vt, width)
        assert torch.equal(fm, mask)
        np.testing.assert_array_equal(fp.numpy(), pcnt.numpy())
        np.testing.assert_array_equal(fc.numpy(), cnt.numpy())


@pytest.mark.parametrize("width", [0, 1, 48, 64])
@pytest.mark.parametrize("P_,W_", [(1, 2048), (37, 2052), (64, 33)])
def test_split_pair_at_slice_shapes(P_, W_, width):
    """range_mask_count then masked_plane_popcounts = the reference's
    composition at the shapes where the CUDA kernels' pack slices and load
    forms change (one pack; W = 2052, whose last slice is one quad short;
    W = 33), with every incoming mask (absent = every row; rows only in
    each pack's last word, under a range that holds every value) and in
    every layout the wrappers take: plane-major, the pack-major view, a
    misaligned copy (mask too) and pack stride W + 1."""
    rng = np.random.default_rng(P_ * 1000 + W_ + width)
    mins = rng.integers(0, 500, P_, dtype=np.uint64)
    planes = rng.integers(0, 1 << 32, (max(width, 1), P_, W_),
                          dtype=np.uint64).astype(np.uint32)
    if width == 0:
        planes[:] = 0
    layouts = split_layouts(WD.to_words(planes, "cpu"))
    for mname, m in split_masks(rng, P_, W_).items():
        lo, hi = (0, (1 << 64) - 1) if mname == "last word" \
            else (100, 100 + (1 << min(width, 40)) // 2)
        ops = [WD.to_words(a, "cpu") for a in SK.range_consts(
            mins, np.uint64(lo), np.uint64(hi), width)]
        valid = np.full((P_, W_), 0xFFFFFFFF, np.uint32) if m is None else m
        rmask, rpcnt, rcnt = (np.asarray(a) for a in PS.fused_range_sum_ref(
            jnp.asarray(planes), jnp.asarray(mins), jnp.asarray(valid),
            jnp.uint64(lo), jnp.uint64(hi), width))
        if mname == "last word":
            assert (rcnt > 0).all() and not rmask[:, :-1].any()
        for layout, pt in layouts.items():
            mt = None if m is None else WD.to_words(m, "cpu")
            if mt is not None and layout == "misaligned":
                mt = misaligned_copy(mt)
            what = f"{layout}, mask {mname}"
            mask, cnt = SK.range_mask_count(pt, *ops, mt, width)
            pcnt, cnt2 = SK.masked_plane_popcounts(pt, mask, width)
            np.testing.assert_array_equal(WD.from_words(mask), rmask,
                                          err_msg=what)
            np.testing.assert_array_equal(cnt.numpy(), rcnt, err_msg=what)
            np.testing.assert_array_equal(cnt2.numpy(), rcnt, err_msg=what)
            np.testing.assert_array_equal(pcnt.numpy(), rpcnt, err_msg=what)


def test_wrappers_reject_bad_planes(rng):
    planes_pm, _pk, (lo, hi, fl), mask_in = _case(rng, 8)
    ops = [WD.to_words(a, "cpu") for a in (lo, hi, fl)]
    pt, mt = WD.to_words(planes_pm, "cpu"), WD.to_words(mask_in, "cpu")
    with pytest.raises(ValueError, match="last axis"):
        SK.range_mask_count(pt.permute(0, 2, 1).contiguous().permute(0, 2, 1),
                            *ops, mt, 8)
    with pytest.raises(ValueError, match="shape"):
        SK.masked_plane_popcounts(pt[:, :-1], mt, 8)
    with pytest.raises(TypeError):
        SK.masked_plane_popcounts(pt.to(torch.int64), mt, 8)
    with pytest.raises(ValueError, match="width"):
        SK.range_mask_count(pt, *ops, mt, 65)
