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
