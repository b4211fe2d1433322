"""The plain version of the tile bitonic sort (ops/sort_kernels.py).

The TPU kernel it ports (probes/msort_probe.py `call` :138, `kern_sort`
:127) is a closure inside the probe's main() and cannot be imported, so
the oracle is the probe's own: `simulate_np` below is a copy of its exact
numpy twin of the staged network (probes/msort_probe.py:84-100), per tile
column, ties included. Where the keys of a column are distinct the network
result is also unique, and equals np.sort. This file imports no jax."""

import numpy as np
import pytest
import torch

from knoxdb_tpu_torch.ops import sort_kernels as S8

R, C = S8.R, S8.C


def simulate_np(keys2, pays2):
    """Exact numpy twin of the staged network (per tile column); copied
    from probes/msort_probe.py:84-100."""
    kv = keys2.copy()
    pv = pays2.copy()
    rows = np.arange(R)
    for k, d in S8.STAGES:
        i = rows.reshape(-1, 2 * d)
        a, b = i[:, :d].reshape(-1), i[:, d:].reshape(-1)
        asc = ((a // k) % 2) == 0
        swap = np.where(asc, kv[a] > kv[b], kv[a] < kv[b])
        ka, kb = kv[a].copy(), kv[b].copy()
        pa, pb = pv[a].copy(), pv[b].copy()
        kv[a] = np.where(swap, kb, ka)
        kv[b] = np.where(swap, ka, kb)
        pv[a] = np.where(swap, pb, pa)
        pv[b] = np.where(swap, pa, pb)
    return kv, pv


def _tpose(x, n):
    """The probe's in-kernel transposes: [B, R, C] tiles, n times."""
    for _ in range(n):
        x = x.transpose(0, 2, 1).reshape(-1, R, C)
    return x


def _run(keys, pay, ntpose):
    ko, po = S8.tile_bitonic_sort(torch.from_numpy(keys.view(np.int32)),
                                  torch.from_numpy(pay.view(np.int32)),
                                  ntpose)
    return (ko.numpy().view(np.uint32).reshape(-1, R, C),
            po.numpy().view(np.uint32).reshape(-1, R, C))


def test_stage_list():
    assert len(S8.STAGES) == 45
    assert S8.STAGES[:3] == [(2, 1), (4, 2), (4, 1)]
    assert S8.STAGES[-1] == (512, 1)


@pytest.mark.parametrize("ntpose", [0, 8])
def test_ties_equal_the_probe_twin(ntpose):
    """Keys in [0, 8): ties everywhere, so the payloads' places are the
    network's own; every column of 2 tiles against simulate_np."""
    rng = np.random.default_rng(3)
    n = 2 * S8.TILE
    keys = rng.integers(0, 8, n).astype(np.uint32)
    keys[:R] = 0xFFFFFFFF                        # the unsigned top
    pay = np.arange(n, dtype=np.uint32)
    before = S8.PLAIN_CALLS["tile_bitonic_sort"]
    ko, po = _run(keys, pay, ntpose)
    assert S8.PLAIN_CALLS["tile_bitonic_sort"] == before + 1
    src_k, src_p = keys.reshape(-1, R, C), pay.reshape(-1, R, C)
    wk, wp = np.empty_like(src_k), np.empty_like(src_p)
    for b in range(src_k.shape[0]):
        for c in range(C):
            wk[b, :, c], wp[b, :, c] = simulate_np(src_k[b, :, c],
                                                   src_p[b, :, c])
    np.testing.assert_array_equal(ko, _tpose(wk, ntpose))
    np.testing.assert_array_equal(po, _tpose(wp, ntpose))


@pytest.mark.parametrize("ntpose", [0, 8])
def test_distinct_keys_equal_np_sort(ntpose):
    """Full-range u32 keys, distinct within every column (a permutation
    per tile): the network's result is the sorted column, payloads
    following their keys."""
    rng = np.random.default_rng(4)
    B = 3
    keys = np.concatenate([
        rng.choice(1 << 32, S8.TILE, replace=False) for _ in range(B)
    ]).astype(np.uint32)
    pay = rng.integers(0, 1 << 32, B * S8.TILE, dtype=np.uint64) \
        .astype(np.uint32)
    ko, po = _run(keys, pay, ntpose)
    src_k, src_p = keys.reshape(B, R, C), pay.reshape(B, R, C)
    order = np.argsort(src_k, axis=1)
    wk = np.take_along_axis(src_k, order, 1)
    wp = np.take_along_axis(src_p, order, 1)
    np.testing.assert_array_equal(ko, _tpose(wk, ntpose))
    np.testing.assert_array_equal(po, _tpose(wp, ntpose))


def test_rejects_bad_operands():
    k = torch.zeros(S8.TILE + 1024, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        S8.tile_bitonic_sort(k, k.clone())
    k = torch.zeros(S8.TILE, dtype=torch.int32)
    with pytest.raises(TypeError):
        S8.tile_bitonic_sort(k.to(torch.int64), k)
    with pytest.raises(ValueError):
        S8.tile_bitonic_sort(k, k[:S8.TILE // 2])
    with pytest.raises(ValueError):
        S8.tile_bitonic_sort(k, k, ntpose=-1)
    ko, po = S8.tile_bitonic_sort(k[:0], k[:0])
    assert ko.numel() == po.numel() == 0


# ------------------------------------------- the kernel's warp schedule --

LANE_ROWS = 16          # rows a lane holds (csrc/sort_kernels.cu)
SLAB_COLS = 16          # columns, one per warp, of a CTA


def warp_schedule() -> list[tuple[str, int, int, int]]:
    """How the kernel runs STAGES: ("registers", k, d, 0) where d <
    LANE_ROWS (both rows in one lane), else ("shuffle", k, d, lane mask
    d // LANE_ROWS) (__shfl_xor_sync between lanes)."""
    return [("registers", k, d, 0) if d < LANE_ROWS
            else ("shuffle", k, d, d // LANE_ROWS) for k, d in S8.STAGES]


def slab_image(slab: int, ntpose: int) -> list[int]:
    """The kernel's store order for slab `slab` (columns 16 slab .. 16 slab
    + 15 of a tile): position u holds the flat tile position s' that the
    u-th store writes, the slab's three fixed column bits inserted at their
    places under the rotation by m = 9 ntpose mod 16 (the transposes);
    s' is the rotation of the source s = row * C + col."""
    m = (9 * (ntpose % 16)) % 16
    fixed = sorted(((4 + m + i) % 16, (slab >> i) & 1) for i in range(3))
    out = []
    for u in range(R * SLAB_COLS):
        x = u
        for q, b in fixed:
            low = x & ((1 << q) - 1)
            x = ((x >> q) << (q + 1)) | (b << q) | low
        out.append(x)
    return out


def simulate_warp_np(keys2, pays2):
    """A numpy model of one warp of the CUDA kernel on one column: lane l
    holds rows 16l .. 16l + 15 in registers; through merge phase k the
    keys of rows a with (a / k) odd are held complemented, so a
    "registers" stage puts the min of two registers of a lane first and a
    "shuffle" stage swaps with lane l ^ mask, the lower lane keeping the
    min and the upper the max (csrc/sort_kernels.cu)."""
    L = LANE_ROWS
    kv = keys2.reshape(R // L, L).copy()
    pv = pays2.reshape(R // L, L).copy()
    lane = np.arange(R // L)[:, None]
    row = lane * L + np.arange(L)[None, :]
    ones = np.uint32(0xFFFFFFFF)

    def direction(k):
        return np.where((row // k) % 2 == 1, ones, np.uint32(0))

    prev = np.zeros_like(kv)
    for kind, k, d, m in warp_schedule():
        if d == k // 2:                            # a merge phase begins
            kv ^= prev ^ direction(k)
            prev = direction(k)
        if kind == "registers":
            for i in range(L):
                if i & d:
                    continue
                ka, kb = kv[:, i].copy(), kv[:, i + d].copy()
                pa, pb = pv[:, i].copy(), pv[:, i + d].copy()
                sw = ka > kb
                kv[:, i], kv[:, i + d] = np.minimum(ka, kb), \
                    np.maximum(ka, kb)
                pv[:, i], pv[:, i + d] = np.where(sw, pb, pa), \
                    np.where(sw, pa, pb)
        else:
            flip = np.where((lane & m) != 0, ones, np.uint32(0))
            ok, op = kv[lane[:, 0] ^ m], pv[lane[:, 0] ^ m]
            take = (ok ^ flip) < (kv ^ flip)
            kv, pv = np.where(take, ok, kv), np.where(take, op, pv)
    kv ^= prev
    return kv.reshape(-1), pv.reshape(-1)


def test_warp_schedule():
    """30 stages in a lane's registers, 15 as shuffles at lane masks
    1-16, in STAGES' order."""
    sched = warp_schedule()
    assert [(k, d) for _kind, k, d, _m in sched] == S8.STAGES
    shuf = [(k, d, m) for kind, k, d, m in sched if kind == "shuffle"]
    assert len(shuf) == 15 and len(sched) - len(shuf) == 30
    assert all(d >= LANE_ROWS and m == d // LANE_ROWS
               for k, d, m in shuf)
    assert sorted({m for _k, _d, m in shuf}) == [1, 2, 4, 8, 16]


@pytest.mark.parametrize("krange", [8, 1 << 32])
def test_warp_model_equals_network(krange):
    """The warp model gives the probe twin's network exactly, ties
    included (keys in [0, 8) and the unsigned top), and
    tile_bitonic_sort_torch on the same tile."""
    rng = np.random.default_rng(krange % 997)
    keys = rng.integers(0, krange, S8.TILE, dtype=np.uint64) \
        .astype(np.uint32)
    keys[:2 * C] = 0xFFFFFFFF
    pay = np.arange(S8.TILE, dtype=np.uint32)
    ko, po = _run(keys, pay, 0)
    src_k, src_p = keys.reshape(R, C), pay.reshape(R, C)
    for c in range(0, C, 5):
        wk, wp = simulate_warp_np(src_k[:, c], src_p[:, c])
        tk, tp = simulate_np(src_k[:, c], src_p[:, c])
        np.testing.assert_array_equal(wk, tk)
        np.testing.assert_array_equal(wp, tp)
        np.testing.assert_array_equal(wk, ko[0, :, c])
        np.testing.assert_array_equal(wp, po[0, :, c])


def _rot16(x, m):
    return ((x << m) | (x >> (16 - m))) & 0xFFFF


@pytest.mark.parametrize("ntpose", list(range(16)) + [17, 24])
def test_slab_image(ntpose):
    """The kernel's store order: for every slab, u -> s' is increasing and
    s' is the rotation (the transposes) of a source position in that
    slab, so the slabs' images partition the tile; runs of 4 consecutive
    positions (one 16-byte store) for all ntpose but 3, 5, 10, 12 mod 16;
    placing every slab's sorted columns by it equals the plain version."""
    m = (9 * ntpose) % 16
    seen = np.zeros(S8.TILE, bool)
    for slab in range(C // SLAB_COLS):
        img = np.array(slab_image(slab, ntpose))
        assert (np.diff(img) > 0).all()
        src = _rot16(img, (16 - m) % 16)
        assert ((src % C) // SLAB_COLS == slab).all()
        assert not seen[img].any()
        seen[img] = True
        runs4 = (img.reshape(-1, 4) - img.reshape(-1, 4)[:, :1]
                 == np.arange(4)).all()
        assert runs4 == (ntpose % 16 not in (3, 5, 10, 12))
    assert seen.all()
    s = np.arange(S8.TILE)
    np.testing.assert_array_equal(
        _rot16(s, m), _tpose(s.reshape(1, R, C), ntpose).reshape(-1)
        .argsort())
