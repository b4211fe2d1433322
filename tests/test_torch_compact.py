"""knoxdb_tpu_torch.ops.compact against knoxdb_tpu.ops.compact: the same
numpy inputs through both, outputs equal bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knoxdb_tpu.ops import bitset as RBS
from knoxdb_tpu.ops import compact as RCP
from knoxdb_tpu_torch.ops import compact as TCP
from knoxdb_tpu_torch.ops import words as WD


def _u32(t):
    return WD.from_words(t)


@pytest.mark.parametrize("n,p,cap,base", [
    (1000, 0.3, 512, 0),         # more set rows than cap: the first cap
    (1000, 0.3, 4096, 7),        # cap past n, with a base
    (4096, 0.0, 8, 0),           # empty mask
    (4096, 1.0, 4096, 0),        # full mask, cap == n
    (777, 0.05, 64, (1 << 32) - 5),   # base + row wraps mod 2^32
])
def test_mask_to_indexes(rng, n, p, cap, base):
    mask = rng.random(n) < p
    ridx, rcnt = RCP.mask_to_indexes(jnp.asarray(mask), cap, base)
    tidx, tcnt = TCP.mask_to_indexes(torch.from_numpy(mask), cap, base)
    np.testing.assert_array_equal(_u32(tidx), np.asarray(ridx))
    assert int(tcnt) == int(rcnt) and tcnt.dtype == torch.int64


def test_packed_mask_and_compact_rows(rng):
    P, N = 3, 256
    mask = rng.random((P, N)) < 0.4
    words = np.stack([RBS.np_pack_mask(mask[i]) for i in range(P)])
    ridx, rcnt = RCP.packed_mask_to_indexes(jnp.asarray(words), 512)
    tidx, tcnt = TCP.packed_mask_to_indexes(WD.to_words(words, "cpu"), 512)
    np.testing.assert_array_equal(_u32(tidx), np.asarray(ridx))
    assert int(tcnt) == int(rcnt)
    limbs = rng.integers(0, 1 << 32, (2, P * N), dtype=np.uint64) \
        .astype(np.uint32)
    r_rows, r_cnt = RCP.compact_rows(jnp.asarray(limbs),
                                     jnp.asarray(mask.reshape(-1)), 256)
    t_rows, t_cnt = TCP.compact_rows(WD.to_words(limbs, "cpu"),
                                     torch.from_numpy(mask.reshape(-1)), 256)
    np.testing.assert_array_equal(_u32(t_rows), np.asarray(r_rows))
    assert int(t_cnt) == int(r_cnt)


def test_take_rows_sentinels(rng):
    limbs = rng.integers(0, 1 << 32, (1, 100), dtype=np.uint64) \
        .astype(np.uint32)
    idx = np.array([5, 0xFFFFFFFF, 99, 0, 0xFFFFFFFF, 42], np.uint32)
    want = RCP.take_rows(jnp.asarray(limbs), jnp.asarray(idx))
    got = TCP.take_rows(WD.to_words(limbs, "cpu"), WD.to_words(idx, "cpu"))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_masked_row_ids(rng):
    P, N = 4, 64
    mask = rng.random((P, N)) < 0.5
    base = np.array([0, 1000, (1 << 40) + 3, (1 << 63) + 9], np.uint64)
    want = RCP.masked_row_ids(jnp.asarray(mask), jnp.asarray(base))
    got = TCP.masked_row_ids(torch.from_numpy(mask),
                             torch.from_numpy(base.view(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.asarray(want))


@pytest.mark.parametrize("p,kcap", [(0.01, 16), (0.5, 100), (0.0, 8)])
def test_first_k_indexes(rng, p, kcap):
    P, N = 4, 1024
    mask = rng.random((P, N)) < p
    words = np.stack([RBS.np_pack_mask(mask[i]) for i in range(P)])
    ridx, rcnt = RCP.first_k_indexes(jnp.asarray(words), kcap)
    tidx, tcnt = TCP.first_k_indexes(WD.to_words(words, "cpu"), kcap)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(ridx))
    assert int(tcnt) == int(rcnt)


@pytest.mark.parametrize("w", [1, 17, 32, 48, 64, 128])
def test_gather_plane_values(rng, w):
    P, W, N = 3, 8, 256
    planes = rng.integers(0, 1 << 32, (w, P, W), dtype=np.uint64) \
        .astype(np.uint32)
    idx = rng.integers(0, P * N, 40).astype(np.int32)
    want = RCP.gather_plane_values(jnp.asarray(planes), jnp.asarray(idx), N)
    got = TCP.gather_plane_values(WD.to_words(planes, "cpu"),
                                  torch.from_numpy(idx), N)
    assert len(got) == len(want)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(_u32(g), np.asarray(r))
