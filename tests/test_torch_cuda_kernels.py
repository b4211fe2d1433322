"""CUDA scan kernels vs their plain PyTorch versions, on the card.

The kernels have no CPU mode, so these tests skip without a GPU; run them
on one with `python -m pytest -m cuda tests/test_torch_cuda_kernels.py`.
This file imports no jax (the card's machine has none)."""

import numpy as np
import pytest
import torch

from knoxdb_tpu_torch.ops import scan_kernels as SK
from knoxdb_tpu_torch.ops import words as WD
from knoxdb_tpu_torch.testing import random_tree_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _dev(case, device):
    planes, leaf_ops, leaf_field, mask_in, fwidths, specs = case
    return ([WD.to_words(p, device) for p in planes],
            [tuple(WD.to_words(a, device) for a in op) for op in leaf_ops],
            leaf_field, WD.to_words(mask_in, device), fwidths, specs)


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


@pytest.mark.parametrize("W", [64, 2048, 40])
@pytest.mark.parametrize("widths,nleaf", [((16,), 1), ((41, 1), 2),
                                          ((64, 0, 48), 3)])
def test_tree_kernel_equals_plain(cuda, W, widths, nleaf):
    rng = np.random.default_rng(len(widths) * 1000 + W)
    specs = tuple((f, f % 2 == 0, True) for f in range(len(widths)))
    args = _dev(random_tree_case(rng, widths, 24, W, nleaf, specs), cuda)
    before = SK.LAUNCHES["fused_tree_agg"]
    mask, cnt, parts = SK.fused_tree_agg(*args)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["fused_tree_agg"] == before + 1
    rmask, rcnt, rparts = SK.fused_tree_agg_torch(*args)
    _same(mask, rmask, "mask")
    _same(cnt, rcnt, "cnt")
    for d, rd in zip(parts, rparts):
        assert d.keys() == rd.keys()
        for k in d:
            _same(d[k], rd[k], k)
    assert int(cnt[-1]) == 0          # the empty pack


@pytest.mark.parametrize("width", [0, 1, 16, 41, 64])
def test_range_sum_kernel_equals_plain(cuda, width):
    rng = np.random.default_rng(width)
    planes, ops, _lf, mask_in, _w, _s = random_tree_case(
        rng, (width,), 32, 2048, 1, ())
    args = (WD.to_words(planes[0], cuda),
            *(WD.to_words(a, cuda) for a in ops[0]),
            WD.to_words(mask_in, cuda), width)
    got = SK.fused_range_sum_masked(*args)
    want = SK.fused_range_sum_masked_torch(*args)
    for g, w, name in zip(got, want, ("mask", "pcnt", "cnt")):
        _same(g, w, name)


def test_wrapper_rejects_bad_operands(cuda):
    rng = np.random.default_rng(7)
    planes, leaf_ops, leaf_field, mask_in, fwidths, specs = _dev(
        random_tree_case(rng, (8,), 4, 64, 1, ((0, True, False),)), cuda)
    with pytest.raises(ValueError):
        SK.fused_tree_agg(planes, leaf_ops, leaf_field, mask_in.cpu(),
                          fwidths, specs)
    with pytest.raises(TypeError):
        SK.fused_tree_agg([p.to(torch.int64) for p in planes], leaf_ops,
                          leaf_field, mask_in, fwidths, specs)
