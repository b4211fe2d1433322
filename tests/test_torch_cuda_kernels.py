"""CUDA scan (fused, split and strided), group, group-chunk and tile-sort
kernels vs their plain PyTorch versions, on the card.

The kernels have no CPU mode, so these tests skip without a GPU; run them
on one with `python -m pytest -m cuda tests/test_torch_cuda_kernels.py`.
This file imports no jax (the card's machine has none)."""

import numpy as np
import pytest
import torch

from knoxdb_tpu_torch.ops import bitset as TBS
from knoxdb_tpu_torch.ops import group_kernels as GK
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


def _split_case(width, P, W, device, seed, mask="random"):
    """Operands of the split kernels: random planes and range constants,
    with a random, empty, full or absent incoming mask."""
    rng = np.random.default_rng(seed)
    planes, ops, _lf, mask_in, _w, _s = random_tree_case(
        rng, (width,), P, W, 1, (), empty_pack=False)
    if mask == "empty":
        mask_in[:] = 0
    elif mask == "full":
        mask_in[:] = 0xFFFFFFFF
    return (WD.to_words(planes[0], device),
            *(WD.to_words(a, device) for a in ops[0]),
            None if mask is None else WD.to_words(mask_in, device), width)


@pytest.mark.parametrize("mask", ["random", "empty", "full", None])
@pytest.mark.parametrize("width", [0, 1, 16, 33, 64])
def test_range_mask_count_kernel_equals_plain(cuda, width, mask):
    """Kernel 5a at Pg = 13 (not a multiple of 8) and W = 2048 and 40."""
    for W in (2048, 40):
        args = _split_case(width, 13, W, cuda, width * 7 + W, mask)
        before = SK.LAUNCHES["range_mask_count"]
        got = SK.range_mask_count(*args)
        torch.cuda.synchronize()
        assert SK.LAUNCHES["range_mask_count"] == before + 1
        want = SK.range_mask_count_torch(*args)
        assert got[1].dtype == torch.int64
        for g, w, name in zip(got, want, ("mask", "cnt")):
            _same(g, w, name)


@pytest.mark.parametrize("mask", ["random", "empty", "full"])
@pytest.mark.parametrize("width", [0, 1, 16, 33, 64])
def test_masked_plane_popcounts_kernel_equals_plain(cuda, width, mask):
    """Kernel 5b at Pg = 13 and W = 2048 and 40."""
    for W in (2048, 40):
        planes, _lo, _hi, _fl, m, _w = _split_case(width, 13, W, cuda,
                                                   width * 11 + W, mask)
        before = SK.LAUNCHES["masked_plane_popcounts"]
        got = SK.masked_plane_popcounts(planes, m, width)
        torch.cuda.synchronize()
        assert SK.LAUNCHES["masked_plane_popcounts"] == before + 1
        want = SK.masked_plane_popcounts_torch(planes, m, width)
        for g, w, name in zip(got, want, ("pcnt", "cnt")):
            _same(g, w, name)


@pytest.mark.parametrize("width", [1, 16, 33, 64])
def test_pack_major_view_equals_plane_major(cuda, width):
    """Kernels #1, 5a and 5b on the permuted view of a pack-major tensor
    [P, w, W] (no copy) give the plane-major results bit for bit."""
    planes, lo, hi, fl, m, _w = _split_case(width, 13, 2048, cuda, width)
    pm = planes.permute(1, 0, 2).contiguous().permute(1, 0, 2)
    assert pm.shape == planes.shape
    assert width == 1 or pm.stride() == (2048, width * 2048, 1)
    for a, b in zip(SK.fused_range_sum_masked(planes, lo, hi, fl, m, width),
                    SK.fused_range_sum_masked(pm, lo, hi, fl, m, width)):
        _same(a, b, "fused_range_sum_masked")
    for a, b in zip(SK.range_mask_count(planes, lo, hi, fl, m, width),
                    SK.range_mask_count(pm, lo, hi, fl, m, width)):
        _same(a, b, "range_mask_count")
    for a, b in zip(SK.masked_plane_popcounts(planes, m, width),
                    SK.masked_plane_popcounts(pm, m, width)):
        _same(a, b, "masked_plane_popcounts")
    with pytest.raises(ValueError, match="last axis"):
        SK.range_mask_count(planes.permute(0, 2, 1).contiguous()
                            .permute(0, 2, 1), lo, hi, fl, m, width)


@pytest.mark.parametrize("mode", ["EQ", "LT", "LE", "GT", "GE", "RANGE"])
def test_wide_bitpack_range_leaf_runs_ladder_kernel(cuda, mode):
    """A range-family leaf over a wide (INT128) BITPACK column launches the
    ladder kernel once per scan, and its mask, count and sum equal the
    CPU scan's (the plain versions)."""
    from knoxdb_tpu_torch.exec.device import DeviceSegment
    from knoxdb_tpu_torch.exec.scan import AggSpec, SegmentScanner
    from knoxdb_tpu_torch.pack.segment import build_segment
    from knoxdb_tpu_torch.query.filter import Filter, leaf
    from knoxdb_tpu_torch.schema.schema import Builder
    from knoxdb_tpu_torch.types import FieldType, FilterMode

    rng = np.random.default_rng(11)
    n, pack = 4096, 1024
    big = np.empty(n, object)
    for i in range(n):
        big[i] = (i // pack - 1) * (1 << 80) + int(rng.integers(0, 1 << 33))
    sch = Builder("w").pk("id").add("big", FieldType.INT128).finish()
    seg = build_segment(sch, {"id": np.arange(1, n + 1, dtype=np.uint64),
                              "big": big}, pack_size=pack)
    vals = sorted(big.tolist())
    # bounds inside a pack, so that the zone maps cannot decide every pack
    value = (vals[n // 4 + 100], vals[3 * n // 4 + 100]) \
        if mode == "RANGE" else vals[n // 2 + 100]
    tree = leaf(Filter(sch.field("big"), FilterMode[mode], value)).optimize()
    aggs = [AggSpec("count"), AggSpec("sum", "big")]
    out = []
    for dev in ("cpu", cuda):
        sc = SegmentScanner(DeviceSegment(seg, dev))
        assert sc.d.column("big").wide
        fn, args = sc.prepare(tree, [])
        mask = fn(*args)[0].cpu()
        SK.reset_counts()
        res = sc.scan(tree, aggs)
        out.append((mask, res.count, res.aggs, dict(SK.LAUNCHES),
                    dict(SK.PLAIN_CALLS)))
    (m0, c0, a0, l0, p0), (m1, c1, a1, l1, p1) = out
    _same(m1, m0, "mask")
    assert (c1, a1) == (c0, a0) and 0 < c1 < n
    assert l0["range_mask_count"] == 0 and p0["range_mask_count"] == 1
    assert l1["range_mask_count"] == 1 and p1["range_mask_count"] == 0


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


def _group_case(rng, P, N, G, K, device):
    """Random group-kernel operands: gids in [-2, G + 3), a 70% mask,
    carry-stress values (all-ones words) and, for K = 2, square halves of
    values up to 2^32 - 1."""
    from knoxdb_tpu_torch.exec import groupby as GB
    gid = rng.integers(-2, G + 3, (P, N)).astype(np.int32)
    mask = rng.random((P, N)) < 0.7
    words = np.stack([TBS.np_pack_mask(mask[p]) for p in range(P)])
    vals = rng.integers(0, 1 << 32, (2, P, N), dtype=np.uint64) \
        .astype(np.uint32)
    vals[:, 0, :64] = 0xFFFFFFFF
    args = [torch.from_numpy(gid).to(device), WD.to_words(words, device),
            WD.to_words(vals[0], device), WD.to_words(vals[1], device)]
    if K == 2:
        args[3] = torch.zeros_like(args[3])
        args += list(GB.square_halves(args[2]))
    return args


@pytest.mark.parametrize("G", [1, 200, 1000, 1229, 2049, 8192, 65536])
@pytest.mark.parametrize("K", [1, 2])
def test_group_kernels_equal_plain(cuda, G, K):
    rng = np.random.default_rng(G * 10 + K)
    args = _group_case(rng, 4, 32768, G, K, cuda)
    if K == 1:
        kern, plain, name = (GK.fused_group_partials,
                             GK.fused_group_partials_torch,
                             "fused_group_partials")
    else:
        kern, plain, name = (GK.fused_group_moments_partials,
                             GK.fused_group_moments_partials_torch,
                             "fused_group_moments_partials")
    before = GK.LAUNCHES[name]
    got = kern(*args, G)
    torch.cuda.synchronize()
    assert GK.LAUNCHES[name] == before + 1
    want = plain(*args, G)
    assert len(got) == len(want) == 1 + 2 * K
    for g, w in zip(got, want):
        _same(g, w, name)


def test_group_wrapper_rejects_bad_operands(cuda):
    rng = np.random.default_rng(3)
    gid, mask, vlo, vhi = _group_case(rng, 2, 1024, 10, 1, cuda)
    with pytest.raises(ValueError):
        GK.fused_group_partials(gid, mask.cpu(), vlo, vhi, 10)
    with pytest.raises(TypeError):
        GK.fused_group_partials(gid, mask, vlo.to(torch.int64), vhi, 10)


@pytest.mark.parametrize("ntpose", [0, 8])
@pytest.mark.parametrize("B,krange", [(4, 8), (32, 1 << 32)])
def test_tile_sort_kernel_equals_plain(cuda, B, krange, ntpose):
    """Kernel #8 against its plain version, bit for bit: 4 tiles of keys in
    [0, 8) (ties everywhere: the payloads' places are the network's) and
    32 tiles of full-range u32 keys, payload = arange."""
    from knoxdb_tpu_torch.ops import sort_kernels as S8
    rng = np.random.default_rng(3)
    n = B * S8.TILE
    keys = rng.integers(0, krange, n, dtype=np.uint64).astype(np.uint32)
    k = WD.to_words(keys, cuda)
    p = torch.arange(n, dtype=torch.int32, device=cuda)
    before = S8.LAUNCHES["tile_bitonic_sort"]
    ko, po = S8.tile_bitonic_sort(k, p, ntpose)
    torch.cuda.synchronize()
    assert S8.LAUNCHES["tile_bitonic_sort"] == before + 1
    rk, rp = S8.tile_bitonic_sort_torch(k, p, ntpose)
    _same(ko, rk, "keys")
    _same(po, rp, "pay")


def test_tile_sort_wrapper_rejects_bad_operands(cuda):
    from knoxdb_tpu_torch.ops import sort_kernels as S8
    k = torch.zeros(S8.TILE, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        S8.tile_bitonic_sort(k, k.cpu())
    with pytest.raises(ValueError):
        S8.tile_bitonic_sort(k[:1000], k[:1000])


def _chunk_case(rng, n, H, L, C, device, lo=-5000, extra=5000):
    gid = rng.integers(lo, H * L + extra, n).astype(np.int32)
    gid[:4] = [-1, -(1 << 31), (1 << 31) - 1, H * L]
    vlo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    vhi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    return (torch.from_numpy(gid).to(device), WD.to_words(vlo, device),
            WD.to_words(vhi, device))


@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("H,L,shift,C,S", [
    (128, 8, 3, 4, 8), (128, 8, 3, 4, 16), (128, 8, 3, 4, 32),
    (128, 8, 3, 6, 8), (256, 32, 5, 6, 8), (256, 32, 5, 6, 32),
    (128, 1, 0, 8, 8), (256, 16, 4, 0, 8)])
def test_chunk_kernel_equals_plain(cuda, H, L, shift, C, S, out_dtype, band):
    """Kernels #6 / #7 against the plain version, bit for bit: both probe
    geometries (the second needs 224 KiB of dynamic shared memory), both
    output types and layouts, a ragged last block, negative and sentinel
    gids."""
    from knoxdb_tpu_torch.ops import group_chunk_kernels as GCK
    rng = np.random.default_rng(H + L + C + S)
    n = S * 1024 * 5 + 777
    gid, vlo, vhi = _chunk_case(rng, n, H, L, C, cuda)
    before = GCK.LAUNCHES["group_chunk_partials"]
    got = GCK.group_chunk_partials(gid, vlo, vhi, H, L, shift, C, S=S,
                                   out_dtype=out_dtype, band=band)
    torch.cuda.synchronize()
    assert GCK.LAUNCHES["group_chunk_partials"] == before + 1
    want = GCK.group_chunk_partials_torch(gid, vlo, vhi, H, L, shift, C, S,
                                          out_dtype, band)
    _same(got, want, "partials")
    assert float(got.sum()) > 0


def test_chunk_kernel_one_hot_group(cuda):
    """Every row in one group: the most contended cell, 255 * S * 1024 in
    float32 exactly; and the out= buffer is written in place."""
    from knoxdb_tpu_torch.ops import group_chunk_kernels as GCK
    n = 32 * 1024 * 3
    gid = torch.full((n,), 999, dtype=torch.int32, device=cuda)
    vlo = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    vhi = torch.zeros(n, dtype=torch.int32, device=cuda)
    out = torch.empty((3, 128, 40), dtype=torch.float32, device=cuda)
    got = GCK.group_chunk_partials(gid, vlo, vhi, 128, 8, 3, 4, S=32,
                                   out=out)
    assert got is out
    _same(got, GCK.group_chunk_partials_torch(gid, vlo, vhi, 128, 8, 3, 4,
                                              32), "partials")
    assert float(got.max()) == 255.0 * 32 * 1024


def test_chunk_wrapper_rejects_bad_operands(cuda):
    from knoxdb_tpu_torch.ops import group_chunk_kernels as GCK
    g = torch.zeros(8192, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        GCK.group_chunk_partials(g, g.cpu(), g, 128, 8, 3, 4)
    with pytest.raises(ValueError):
        GCK.group_chunk_partials(g, g, g, 256, 32, 5, 8)    # 288 KiB
    with pytest.raises(ValueError):
        GCK.group_chunk_partials(g, g[::2], g, 128, 8, 3, 4)


def test_group_count_chunks_on_card(cuda):
    """The chunk route = the exact-halves route, 1 and 3 launches."""
    from knoxdb_tpu_torch.exec import groupby as TGB
    from knoxdb_tpu_torch.ops import group_chunk_kernels as GCK
    rng = np.random.default_rng(5)
    P, N = 4, 16384
    for G, launches in ((1000, 1), (20000, 3)):
        gids = torch.from_numpy(rng.integers(-2, G + 3, (P, N))
                                .astype(np.int32)).to(cuda)
        vals = rng.integers(0, 1 << 48, (P, N), dtype=np.uint64)
        lo, hi = WD.split_u64(vals)
        pair = (WD.to_words(lo, cuda), WD.to_words(hi, cuda))
        words = WD.to_words(np.stack(
            [TBS.np_pack_mask(rng.random(N) < 0.7) for _ in range(P)]), cuda)
        before = GCK.LAUNCHES["group_chunk_partials"]
        counts, chunks = TGB.group_count_chunks(gids, words, pair, G, 6, 0)
        assert GCK.LAUNCHES["group_chunk_partials"] == before + launches
        c2, s_lo, s_hi = TGB.group_count_sum(gids, words, pair, G)
        _same(counts, c2, "counts")
        sums = TGB.mxu_chunk_sums([c.cpu().numpy() for c in chunks])
        assert list(sums) == list(TGB.halves_sum(s_lo, s_hi))


def test_kernels_build_from_csrc(cuda, tmp_path, monkeypatch):
    """Every kernel library builds from knoxdb_tpu_torch/csrc alone, with
    nvcc, into an empty build directory."""
    from knoxdb_tpu_torch.ops import cuda_build
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_lib", None)
    lib = cuda_build.load()
    built = sorted(p.name.split("_")[0] for p in tmp_path.glob("lib*.so"))
    srcs = sorted(f"lib{p.stem.split('_')[0]}"
                  for p in cuda_build.SRC_DIR.glob("*.cu"))
    assert built == srcs, (built, srcs)
    for name in cuda_build._SIGNATURES:
        assert hasattr(lib, name), name
