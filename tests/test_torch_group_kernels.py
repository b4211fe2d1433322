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


def _mode(G, K):
    """The form the plan must pick: LIMBS up to the shared histogram, then
    CLUSTER where its rounds hold two chunks or more, else GLOBAL."""
    if G <= GK.max_shared_groups(K):
        return "limbs"
    shape = GK.cluster_shape(G, K)
    return "cluster" if shape and shape[2] >= GK.MIN_ROUND_CHUNKS \
        else "global"


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("n", [32, 1024 * 63 + 32, 1 << 24, (1 << 31) - 32])
@pytest.mark.parametrize("G", [1, 1000, "max", "max+1", 65536])
def test_group_tile_plan_invariants(G, n, K):
    """No 32-bit counter can overflow, shared memory stays within a
    block's 232,448 bytes, and the LIMBS / CLUSTER / GLOBAL switches fall
    where _mode says."""
    G = _groups(G, K)
    plan = GK.group_tile_plan(n, G, K)
    assert plan.mode == _mode(G, K)
    assert plan.smem <= GK.SMEM_BLOCK
    nchunks = -(-n // GK.CHUNK_ROWS)
    if plan.mode == "limbs":
        assert plan.smem == plan.stages * (GK.stage_bytes(K) + 16) \
            + plan.hist_bytes
        assert 2 <= plan.stages <= GK.MAX_STAGES
        assert plan.hist_bytes == 4 * (1 + 4 * K) * G
        assert 1 <= plan.blocks <= min(nchunks, 132 * GK.BLOCKS_PER_SM)
        # a counter adds at most tile_rows limbs of at most 2^16 - 1, and
        # a block's count at most tile_rows ones
        assert plan.tile_rows <= GK.LIMB_CHUNKS * GK.CHUNK_ROWS
        assert plan.tile_rows * GK.LIMB_MAX < 1 << 32
        assert plan.tile_rows <= n
        assert (plan.cluster, plan.slice, plan.round_chunks) == (0, 0, 0)
    elif plan.mode == "cluster":
        # CARRY counters: a u32 count and per word a u32 sum and a u32 wrap
        # count, each below n < 2^31 whatever the order of the adds
        assert plan.smem == GK.cluster_smem(K, plan.slice, plan.round_chunks)
        assert plan.stages == plan.round_chunks + 1
        assert plan.hist_bytes == 4 * (1 + 4 * K) * plan.slice
        assert plan.cluster in (8, 16) and plan.blocks % plan.cluster == 0
        assert plan.cluster <= plan.blocks <= 132
        assert plan.blocks // plan.cluster <= max(1, -(-nchunks
                                                     // plan.cluster))
        assert plan.cluster * plan.slice >= G
        assert plan.tile_rows == 0 and plan.slice % 4 == 0
        assert GK.MIN_ROUND_CHUNKS <= plan.round_chunks <= GK.ROUND_CHUNKS
    else:
        assert (plan.stages, plan.smem, plan.hist_bytes, plan.tile_rows) \
            == (0, 0, 0, 0)
        per_block = GK.GLOBAL_THREADS * GK.GLOBAL_UNROLL
        assert 1 <= plan.blocks <= min(-(-n // per_block),
                                       132 * GK.GLOBAL_BLOCKS_PER_SM)


def test_group_tile_plan_geometry():
    """The main paths' geometry: config #3 (16,777,216 rows, G = 1000) and
    #6 (4,194,304 rows, G = 1024, K = 2) run LIMBS at two blocks per SM;
    #3c (G = 65,536) runs CLUSTER on 8 clusters of 16 CTAs, 4,096 groups
    a CTA, 3 chunks a round; K = 2 at 20,000 on 8 clusters of 16, 2
    chunks a round, and at 65,536 (one chunk a round) GLOBAL at four
    256-thread blocks per SM; a small input takes one block per chunk;
    the block counts follow the card's SMs and the clusters it reports."""
    c3 = GK.group_tile_plan(1 << 24, 1000, 1)
    assert (c3.mode, c3.blocks, c3.tile_rows) == ("limbs", 264, 1 << 16)
    c6 = GK.group_tile_plan(1 << 22, 1024, 2)
    assert (c6.mode, c6.blocks) == ("limbs", 264)
    c3c = GK.group_tile_plan(1 << 22, 1 << 16, 1)
    assert (c3c.mode, c3c.blocks, c3c.cluster, c3c.slice,
            c3c.round_chunks) == ("cluster", 128, 16, 4096, 3)
    k2 = GK.group_tile_plan(1 << 22, 20000, 2)
    assert (k2.mode, k2.blocks, k2.cluster, k2.slice, k2.round_chunks) \
        == ("cluster", 128, 16, 1252, 2)
    assert (GK.group_tile_plan(1 << 22, 1 << 16, 2).mode,
            GK.group_tile_plan(1 << 22, 1 << 16, 2).blocks) == ("global", 528)
    forced = GK.cluster_plan(1 << 22, 1 << 16, 2, 16)
    assert (forced.mode, forced.blocks, forced.cluster, forced.round_chunks) \
        == ("cluster", 128, 16, 1)
    with pytest.raises(ValueError, match="no cluster of 8"):
        GK.cluster_plan(1 << 22, 1 << 16, 2, 8)
    small = GK.group_tile_plan(3 * 1024 + 32, 10, 1)
    assert (small.blocks, small.tile_rows) == (4, 3 * 1024 + 32)
    assert GK.group_tile_plan(3 * 1024, 20000, 1).blocks == 8
    assert GK.group_tile_plan(1 << 24, 1000, 1, sms=114).blocks == 228
    assert GK.group_tile_plan(1 << 22, 1 << 16, 2, sms=114).blocks == 456
    assert GK.group_tile_plan(1 << 22, 1 << 16, 1, sms=114).blocks == 112
    assert GK.group_tile_plan(1 << 22, 1 << 16, 1, clusters=7).blocks == 112
    assert GK.MODES == {"global": 0, "limbs": 1, "cluster": 2}


@pytest.mark.parametrize("K", [1, 2])
def test_cluster_plan_every_g(K):
    """Every G from max_shared_groups(K) + 1 to 65,536: the cluster shape
    takes 8 or 16 CTAs, a CTA's shared memory (the ring, the slice, two
    outboxes) within 227 KB, the slices of [0, G) covering it
    exactly with a nonempty last slice, and the kernel's multiply-shift
    (gl * ceil(2^32 / slice) >> 32) exact over the span; the plan runs
    CLUSTER while rounds hold two chunks or more (K = 1 everywhere, K = 2
    to 38,336) and GLOBAL past that."""
    gmax = GK.max_shared_groups(K)
    switch = {1: None, 2: 38337}[K]
    for G in range(gmax + 1, 65537):
        S, sl, rc = GK.cluster_shape(G, K)
        assert S in (8, 16) and sl % 4 == 0, G
        assert (S - 1) * sl < G <= S * sl, G
        assert GK.cluster_smem(K, sl, rc) <= GK.SMEM_BLOCK, G
        if rc < GK.ROUND_CHUNKS:
            assert GK.cluster_smem(K, sl, rc + 1) > GK.SMEM_BLOCK, G
        assert S * sl * sl < 1 << 32, G
        mode = GK.group_tile_plan(1 << 22, G, K).mode
        assert mode == ("global" if switch and G >= switch else "cluster"), G
    for G in (gmax + 1, 9137, 20000, 38336, 38337, 65535, 65536):
        S, sl, _rc = GK.cluster_shape(G, K)
        gl = np.arange(S * sl, dtype=np.uint64)
        magic = np.uint64(-(-(1 << 32) // sl))
        np.testing.assert_array_equal((gl * magic) >> np.uint64(32),
                                      gl // np.uint64(sl))


def _cluster_model(gids, words, vals, G, plan):
    """A numpy model of the CLUSTER form: chunk c to CTA c % blocks of
    cluster (c % blocks) // S, its rows into the S slices of that
    cluster's histogram, u32 counters with a wrap count per word read
    from each add's old value, then the flush of every slice as u64
    entries added into the output."""
    n = gids.size
    gid = gids.reshape(-1).astype(np.int64)
    ok = np.unpackbits(words.reshape(-1).view(np.uint8),
                       bitorder="little")[:n].astype(bool)
    ok &= (gid >= 0) & (gid < G)
    chunk = np.arange(n) // GK.CHUNK_ROWS
    cl = (chunk % plan.blocks) // plan.cluster
    out = np.zeros((1 + len(vals), G), np.uint64)
    width = plan.cluster * plan.slice
    for c in range(plan.blocks // plan.cluster):
        sel = ok & (cl == c)
        gl = gid[sel]
        rank, off = gl // plan.slice, gl % plan.slice
        assert (rank < plan.cluster).all()
        cnt = np.zeros((plan.cluster, plan.slice), np.uint32)
        np.add.at(cnt, (rank, off), np.uint32(1))
        ent = [cnt.astype(np.uint64)]
        for v in vals:
            v = v.reshape(-1)[sel].astype(np.uint64)
            # the adds in row order: each old value is the running sum mod
            # 2^32 of the earlier rows of its group
            order = np.argsort(gl, kind="stable")
            g_s, v_s = gl[order], v[order]
            cum = np.cumsum(v_s)
            first = np.r_[True, g_s[1:] != g_s[:-1]]
            start = np.maximum.accumulate(
                np.where(first, np.arange(g_s.size), 0))
            before = cum - v_s - (cum[start] - v_s[start])
            old = before & np.uint64(0xFFFFFFFF)
            wrap = (old + v_s) >= np.uint64(1 << 32)
            s32 = np.zeros(width, np.uint64)
            w32 = np.zeros(width, np.uint64)
            np.add.at(s32, g_s, v_s)
            np.add.at(w32, g_s, wrap.astype(np.uint64))
            s32 &= np.uint64(0xFFFFFFFF)
            assert (w32 < (1 << 31)).all()
            ent.append((s32 + (w32 << np.uint64(32)))
                       .reshape(plan.cluster, plan.slice))
        for k, e in enumerate(ent):
            out[k] += e.reshape(-1)[:G]
    return out


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("G,force", [("max+1", None), (20000, None),
                                     (65536, None), (65536, 16)])
def test_cluster_model_equals_plain(G, force, K):
    """The CLUSTER form's slices and CARRY counters, modelled in numpy on
    its plan (CTAs of a small grid, so every cluster takes rows), equal
    _group_sums_torch bit for bit; and one group taking every row with
    all-ones value words (a wrap on every add) gives n * (2^32 - 1)."""
    G = _groups(G, K)
    rng = np.random.default_rng(G * 3 + K)
    P, N = 2, 16384
    gids = rng.integers(-2, G + 3, (P, N)).astype(np.int32)
    mask = rng.random((P, N)) < 0.7
    words = np.stack([TBS.np_pack_mask(mask[p]) for p in range(P)])
    vals = list(rng.integers(0, 1 << 32, (2 * K, P, N), dtype=np.uint64)
                .astype(np.uint32))
    vals[0][0, :64] = 0xFFFFFFFF
    plan = GK.cluster_plan(P * N, G, K, force or GK.cluster_shape(G, K)[0],
                           clusters=2)
    assert plan.mode == "cluster" and plan.blocks == 2 * plan.cluster
    want = GK._group_sums_torch(torch.from_numpy(gids),
                                WD.to_words(words, "cpu"),
                                [WD.to_words(v, "cpu") for v in vals], G)
    got = _cluster_model(gids, words, vals, G, plan)
    for k, w in enumerate(want):
        np.testing.assert_array_equal(got[k].view(np.int64), w.numpy())
    one = np.full((P, N), G - 1, np.int32)
    full = np.full((P, N // 32), 0xFFFFFFFF, np.uint32)
    ones = [np.full((P, N), 0xFFFFFFFF, np.uint32)] * (2 * K)
    got = _cluster_model(one, full, ones, G, plan)
    assert int(got[0, G - 1]) == P * N
    for k in range(2 * K):
        assert int(got[1 + k, G - 1]) == P * N * 0xFFFFFFFF
    assert int(got[:, :G - 1].sum()) == 0


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
