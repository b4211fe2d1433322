"""The group kernels' plain versions against the reference's Pallas
kernels (interpret mode) and a python-int oracle.

The port's kernels emit exact int64 sums of the u32 value halves; the
reference's emit per-tile f32 byte-chunk sums that its caller adds in u64
and recombines with mxu_chunk_sums. Both must give the same python-int
sums and counts, bit for bit. On the CPU each wrapper runs its plain
version; the CUDA kernels are held against the same plain versions on the
card (tests/test_torch_cuda_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knoxdb_tpu.exec import groupby as RGB
from knoxdb_tpu.ops import pallas_group as PG
from knoxdb_tpu_torch.exec import groupby as TGB
from knoxdb_tpu_torch.ops import bitset as TBS
from knoxdb_tpu_torch.ops import group_kernels as GK
from knoxdb_tpu_torch.ops import words as WD


def _case(rng, G, P, N, lo=-2, hi_pad=3, p_mask=0.7, vbits=64):
    gids = rng.integers(lo, G + hi_pad, (P, N)).astype(np.int32)
    vals = rng.integers(0, 1 << 63, (P, N), dtype=np.uint64)
    if vbits < 64:
        vals &= np.uint64((1 << vbits) - 1)
    vals[0, :16] = np.uint64(0xFFFFFFFFFFFFFFFF)         # carry stress
    maskb = rng.random((P, N)) < p_mask
    words = np.stack([TBS.np_pack_mask(maskb[p]) for p in range(P)])
    return gids, vals, maskb, words


def _oracle(gids, vals, maskb, G):
    ok = maskb & (gids >= 0) & (gids < G)
    cnt = np.bincount(gids[ok], minlength=G)
    sums = np.zeros(G, object)
    np.add.at(sums, gids[ok], vals[ok].astype(object))
    return cnt, sums


def _port(gids, vals, words, G):
    lo, hi = WD.split_u64(vals)
    before = GK.PLAIN_CALLS["fused_group_partials"]
    c, s_lo, s_hi = GK.fused_group_partials(
        torch.from_numpy(gids), WD.to_words(words, "cpu"),
        WD.to_words(lo, "cpu"), WD.to_words(hi, "cpu"), G)
    assert GK.PLAIN_CALLS["fused_group_partials"] == before + 1
    return c.numpy(), TGB.halves_sum(s_lo, s_hi)


@pytest.mark.parametrize("G,P,N", [(1000, 3, 8192), (200, 1, 4096),
                                   (4096, 2, 8192), (8192, 1, 8192),
                                   (6000, 1, 8192)])
def test_group_partials_vs_pallas(G, P, N):
    """As tests/test_pallas_group.py: the reference's _group_pallas runs
    fused_group_partials in interpret mode, tiles summed in u64."""
    rng = np.random.default_rng(G + P)
    gids, vals, maskb, words = _case(rng, G, P, N)
    rc, chunks, _mn, _mx = RGB._group_pallas(
        jnp.asarray(gids), jnp.asarray(words), jnp.asarray(vals), G)
    c, sums = _port(gids, vals, words, G)
    np.testing.assert_array_equal(c, np.asarray(rc))
    assert list(sums) == list(RGB.mxu_chunk_sums(chunks))
    want_c, want_s = _oracle(gids, vals, maskb, G)
    np.testing.assert_array_equal(c, want_c)
    assert list(sums) == list(want_s)


def test_tile_chunks_equal_exact_halves():
    """The contract change: the reference kernel's f32 per-tile byte
    chunks, summed over tiles and recombined by mxu_chunk_sums, equal the
    exact half sums Σlo + Σhi * 2^32 (the port's mxu_chunk_sums too)."""
    rng = np.random.default_rng(11)
    G, n, C = 300, 20000, 8
    gid = rng.integers(0, G, n).astype(np.int32)
    vals = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    vals[:8] = np.uint64(0xFFFFFFFFFFFFFFFF)
    H, L = RGB._pallas_group_geometry(G)
    lo, hi = WD.split_u64(vals)
    parts = PG.fused_group_partials(
        jnp.asarray(gid), jnp.asarray(lo), jnp.asarray(hi), G, L,
        L.bit_length() - 1, n_chunks=C, interpret=True, H=H)
    acc = np.asarray(parts).astype(np.uint64).sum(axis=0) \
        .reshape(H * L, C + 1)[:G]
    chunk_sums = TGB.mxu_chunk_sums([acc[:, c] for c in range(C)])
    assert list(chunk_sums) == list(RGB.mxu_chunk_sums(
        [acc[:, c] for c in range(C)]))
    N = 32 * -(-n // 32)
    pad = N - n
    gid2 = np.concatenate([gid, np.full(pad, -1, np.int32)])[None]
    vals2 = np.concatenate([vals, np.zeros(pad, np.uint64)])[None]
    words = np.full((1, N // 32), 0xFFFFFFFF, np.uint32)
    c, sums = _port(gid2, vals2, words, G)
    np.testing.assert_array_equal(c, acc[:, C].astype(np.int64))
    assert list(sums) == list(chunk_sums)


def test_group_partials_multipass_big_g():
    """G = 20000 against the reference's multi-pass route (G > 8192:
    pass p reruns the kernel on gid - p*8192), as
    tests/test_pallas_group.py::test_multipass_bigG_oracle does."""
    rng = np.random.default_rng(20000)
    G = 20000
    gids, vals, maskb, words = _case(rng, G, 1, 16384, lo=-5, hi_pad=7,
                                     p_mask=0.9, vbits=40)
    rc, chunks, _mn, _mx = RGB._group_pallas(
        jnp.asarray(gids), jnp.asarray(words), jnp.asarray(vals), G,
        n_chunks=8)
    c, sums = _port(gids, vals, words, G)
    np.testing.assert_array_equal(c, np.asarray(rc))
    assert list(sums) == list(RGB.mxu_chunk_sums(chunks))
    want_c, want_s = _oracle(gids, vals, maskb, G)
    np.testing.assert_array_equal(c, want_c)
    assert list(sums) == list(want_s)


def test_moments_partials_vs_pallas():
    """As tests/test_groupby.py::test_group_moments_mxu_fused_vs_oracle:
    G = 1000, C1 = 4, C2 = 8, values r < 2^31 and their squares, against
    the reference's fused moments kernel and its two-pass XLA route."""
    rng = np.random.default_rng(0xC0FFEE)
    P, N, G = 2, 2048, 1000
    gids = rng.integers(-1, G + 1, (P, N)).astype(np.int32)
    vals = rng.integers(0, 1 << 31, (P, N), dtype=np.uint64)
    vals[0, :8] = np.uint64(0xFFFFFFFF)              # r^2 near 2^64
    mask = rng.random((P, N)) < 0.7
    mw = np.stack([TBS.np_pack_mask(mask[p]) for p in range(P)])
    rlo = jnp.asarray(vals.astype(np.uint32))
    rq = RGB.square_halves(rlo)
    tlo = WD.to_words(vals.astype(np.uint32), "cpu")
    tq = TGB.square_halves(tlo)
    before = GK.PLAIN_CALLS["fused_group_moments_partials"]
    c, sr_lo, sr_hi, sq_lo, sq_hi = GK.fused_group_moments_partials(
        torch.from_numpy(gids), WD.to_words(mw, "cpu"), tlo,
        torch.zeros_like(tlo), *tq, G)
    assert GK.PLAIN_CALLS["fused_group_moments_partials"] == before + 1
    s1 = TGB.halves_sum(sr_lo, sr_hi)
    s2 = TGB.halves_sum(sq_lo, sq_hi)
    for ap in (True, False):
        rc, ch1, ch2 = RGB.group_moments_mxu(
            jnp.asarray(gids), jnp.asarray(mw),
            (rlo, jnp.zeros((P, N), jnp.uint32)), rq, G, 4, 8,
            allow_pallas=ap)
        np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
        assert list(s1) == list(RGB.mxu_chunk_sums(ch1)), ap
        assert list(s2) == list(RGB.mxu_chunk_sums(ch2)), ap
    ok = mask & (gids >= 0) & (gids < G)
    wq = np.zeros(G, object)
    np.add.at(wq, gids[ok], vals[ok].astype(object) ** 2)
    assert list(s2) == list(wq)


def test_wrappers_check_operands():
    """n >= 2^31 rows (a shape, nothing allocated), bad dtypes, shapes
    and devices raise before any kernel runs."""
    big = torch.empty((1 << 26, 32), dtype=torch.int32, device="meta")
    mw = torch.empty((1 << 26, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="exact only below"):
        GK.fused_group_partials(big, mw, big, big, 10)
    with pytest.raises(ValueError, match="exact only below"):
        GK.fused_group_moments_partials(big, mw, big, big, big, big, 10)
    g = torch.zeros((2, 64), dtype=torch.int32)
    m = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        GK.fused_group_partials(g, m, g.to(torch.int64), g, 4)
    with pytest.raises(ValueError):
        GK.fused_group_partials(g, m[:, :1], g, g, 4)
    with pytest.raises(ValueError):
        GK.fused_group_partials(g[:, :40], m, g[:, :40], g[:, :40], 4)
    with pytest.raises(ValueError):
        GK.fused_group_partials(g.to("meta"), m.to("meta"), g.to("meta"),
                                g.to("meta"), 4)


# ------------------------------------------------- the kernel's launch plan --

def _groups(G, K):
    gmax = GK.max_shared_groups(K)
    return {"max": gmax, "max+1": gmax + 1}.get(G, G)


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("n", [32, 1024 * 63 + 32, 1 << 24, (1 << 31) - 32])
@pytest.mark.parametrize("G", [1, 1000, "max", "max+1", 65536])
def test_group_tile_plan_invariants(G, n, K):
    """No 32-bit counter can overflow, shared memory stays within a
    block's 232,448 bytes, and the shared / global switch falls at
    max_shared_groups(K)."""
    G = _groups(G, K)
    plan = GK.group_tile_plan(n, G, K)
    shared = G <= GK.max_shared_groups(K)
    assert plan.mode == ("limbs" if shared else "global")
    assert plan.smem <= GK.SMEM_BLOCK
    if shared:
        assert plan.smem == plan.stages * (GK.stage_bytes(K) + 16) \
            + plan.hist_bytes
        assert plan.hist_bytes == 4 * (1 + 4 * K) * G
        assert 2 <= plan.stages <= GK.MAX_STAGES
        nchunks = -(-n // GK.CHUNK_ROWS)
        assert 1 <= plan.blocks <= min(nchunks, 132 * GK.BLOCKS_PER_SM)
        # a counter adds at most tile_rows limbs of at most 2^16 - 1, and
        # a block's count at most tile_rows ones
        assert plan.tile_rows <= GK.LIMB_CHUNKS * GK.CHUNK_ROWS
        assert plan.tile_rows * GK.LIMB_MAX < 1 << 32
        assert plan.tile_rows <= n
    else:
        assert (plan.stages, plan.smem, plan.hist_bytes, plan.tile_rows) \
            == (0, 0, 0, 0)
        per_block = GK.GLOBAL_THREADS * GK.GLOBAL_UNROLL
        assert 1 <= plan.blocks <= min(-(-n // per_block),
                                       132 * GK.GLOBAL_BLOCKS_PER_SM)


def test_group_tile_plan_geometry():
    """The main paths' geometry: config #3 (16,777,216 rows, G = 1000) and
    #6 (4,194,304 rows, G = 1024, K = 2) run LIMBS at two blocks per SM;
    #3c (G = 65,536) runs GLOBAL at four 256-thread blocks per SM, 528 on
    132 SMs; a small input takes one block per chunk; the block counts
    follow the card's SMs."""
    c3 = GK.group_tile_plan(1 << 24, 1000, 1)
    assert (c3.mode, c3.blocks, c3.tile_rows) == ("limbs", 264, 1 << 16)
    c6 = GK.group_tile_plan(1 << 22, 1024, 2)
    assert (c6.mode, c6.blocks) == ("limbs", 264)
    c3c = GK.group_tile_plan(1 << 22, 1 << 16, 1)
    assert (c3c.mode, c3c.blocks) == ("global", 528)
    small = GK.group_tile_plan(3 * 1024 + 32, 10, 1)
    assert (small.blocks, small.tile_rows) == (4, 3 * 1024 + 32)
    assert GK.group_tile_plan(1 << 24, 1000, 1, sms=114).blocks == 228
    assert GK.group_tile_plan(1 << 22, 1 << 16, 2, sms=114).blocks == 456
    assert GK.MODES == {"global": 0, "limbs": 1}


def test_group_partials_one_group_vs_pallas():
    """G = 1, every row of a few packs in one group (the most contended
    counter), against the reference's _group_pallas in interpret mode."""
    rng = np.random.default_rng(1)
    gids, vals, maskb, words = _case(rng, 1, 3, 4096, lo=0, hi_pad=0,
                                     p_mask=0.95)
    rc, chunks, _mn, _mx = RGB._group_pallas(
        jnp.asarray(gids), jnp.asarray(words), jnp.asarray(vals), 1)
    c, sums = _port(gids, vals, words, 1)
    np.testing.assert_array_equal(c, np.asarray(rc))
    assert list(sums) == list(RGB.mxu_chunk_sums(chunks))
    want_c, want_s = _oracle(gids, vals, maskb, 1)
    np.testing.assert_array_equal(c, want_c)
    assert list(sums) == list(want_s)


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("G", ["max", "max+1"])
def test_group_sums_at_shared_threshold(G, K):
    """G on both sides of the shared / global switch, against a numpy
    oracle (the reference's multi-pass route at these G would rerun its
    interpret-mode kernel per 8192 groups)."""
    G = _groups(G, K)
    rng = np.random.default_rng(G + K)
    P, N = 2, 8192
    gids, vals, maskb, words = _case(rng, G, P, N)
    lo, hi = WD.split_u64(vals)
    parts = [WD.to_words(lo, "cpu"), WD.to_words(hi, "cpu")]
    if K == 2:
        parts += [WD.to_words(hi, "cpu"), WD.to_words(lo, "cpu")]
    fn = GK.fused_group_partials if K == 1 \
        else GK.fused_group_moments_partials
    out = fn(torch.from_numpy(gids), WD.to_words(words, "cpu"), *parts, G)
    want_c, want_s = _oracle(gids, vals, maskb, G)
    np.testing.assert_array_equal(out[0].numpy(), want_c)
    assert list(TGB.halves_sum(out[1], out[2])) == list(want_s)
    if K == 2:
        swapped = (vals >> np.uint64(32)) | (vals << np.uint64(32))
        assert list(TGB.halves_sum(out[3], out[4])) == \
            list(_oracle(gids, swapped, maskb, G)[1])
