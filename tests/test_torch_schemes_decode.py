"""Device decodes of knoxdb_tpu_torch/encode/schemes.py against
knoxdb_tpu/encode/schemes.py on the same seeded numpy inputs.

Integers only, so the tolerance is 0: every output word is bit-identical.
The port carries u32 as int32 and u64 as int64 with the same bits
(ops/words.py); the comparisons view both sides as unsigned."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knoxdb_tpu.encode import schemes as RS
from knoxdb_tpu_torch.encode import schemes as TS
from knoxdb_tpu_torch.ops import words as WD

P, N = 3, 256
WIDTHS = [0, 1, 31, 32, 33, 64]


def _words(a):
    return WD.to_words(np.asarray(a), "cpu")


def _bits(a):
    return torch.from_numpy(WD.bits_from_u64(np.asarray(a, np.uint64)))


def _u32(t):
    return WD.from_words(t)


def _u64(t):
    return t.numpy().view(np.uint64)


def _vals(rng, width, shape=(P, N)):
    if width == 0:
        return np.zeros(shape, np.uint64)
    hi = (1 << width) - 1
    v = rng.integers(0, hi, shape, dtype=np.uint64, endpoint=True)
    v.flat[0], v.flat[-1] = 0, hi
    return v


def _planes(vals, width):
    return np.stack([RS._pack_bitplanes_np(v, width, vals.shape[1])
                     for v in vals], axis=1)


@pytest.mark.parametrize("width", WIDTHS)
def test_decode_bitplanes_u64(rng, width):
    vals = _vals(rng, width)
    planes = _planes(vals, width)
    got = TS.decode_bitplanes_u64(_words(planes), width)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(_u64(got), vals)
    want = RS.decode_bitplanes_u64(jnp.asarray(planes), width)
    np.testing.assert_array_equal(_u64(got), np.asarray(want))


@pytest.mark.parametrize("nlimbs", [1, 2])
def test_key_u64_to_limbs(rng, nlimbs):
    keys = rng.integers(0, 1 << 64, (P, N), dtype=np.uint64)
    keys[0, :3] = [0, (1 << 64) - 1, 1 << 63]
    if nlimbs == 1:
        keys &= np.uint64(0xFFFFFFFF)
    want = RS.key_u64_to_limbs(jnp.asarray(keys), nlimbs)
    got = TS.key_u64_to_limbs(_bits(keys), nlimbs)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_decode_const_and_raw(rng):
    for L in (1, 2, 4, 8):
        cv = rng.integers(0, 1 << 32, (P, L, 1), dtype=np.uint64) \
            .astype(np.uint32)
        np.testing.assert_array_equal(
            _u32(TS.decode_const(_words(cv), P, N)),
            np.asarray(RS.decode_const(jnp.asarray(cv), P, N)))
        rv = rng.integers(0, 1 << 32, (P, L, N), dtype=np.uint64) \
            .astype(np.uint32)
        np.testing.assert_array_equal(
            _u32(TS.decode_raw(_words(rv))),
            np.asarray(RS.decode_raw(jnp.asarray(rv))))


@pytest.mark.parametrize("width", WIDTHS)
def test_decode_bitpack(rng, width):
    vals = _vals(rng, width)
    planes = _planes(vals, width)
    for nlimbs in ((1, 2) if width <= 32 else (2,)):
        # bases that carry out of the low word, and wrap mod 2^64
        top = (1 << 32) if nlimbs == 1 else (1 << 64)
        mins = rng.integers(0, top, P, dtype=np.uint64, endpoint=False)
        mins[0] = top - 1
        want = RS.decode_bitpack(jnp.asarray(planes), jnp.asarray(mins),
                                 width, nlimbs)
        got = TS.decode_bitpack(_words(planes), _bits(mins), width, nlimbs)
        np.testing.assert_array_equal(_u32(got), np.asarray(want))


def _delta_case(rng, width, start):
    """Keys whose zigzag first differences need `width` bits, walking from
    `start` mod 2^64."""
    if width == 0:
        d = np.zeros((P, N), np.int64)
    else:
        half = 1 << (width - 1)
        d = rng.integers(-half, half, (P, N), endpoint=False)
        d[:, 1] = -half                      # zigzag = 2^width - 1
    d[:, 0] = 0
    with np.errstate(over="ignore"):
        keys = (np.cumsum(d.view(np.uint64), axis=1, dtype=np.uint64)
                + np.asarray(start, np.uint64)[:, None])
    return keys


@pytest.mark.parametrize("width", WIDTHS)
def test_decode_delta(rng, width):
    """DELTA decode wraps mod 2^64 and never saturates: the walks start at
    2^63 and at 0 and their first step goes down, across 2^63 and across
    0 to just below 2^64."""
    starts = np.array([1 << 63, 0, 12345], np.uint64)
    keys = _delta_case(rng, min(width, 63), starts)
    packs = [RS.encode_delta(k, 2, width, N) for k in keys]
    planes = np.stack([p.planes for p in packs], axis=1)
    base = np.array([p.min_key for p in packs], np.uint64)
    got = TS.decode_delta(_words(planes), _bits(base), width, 2)
    want = RS.decode_delta(jnp.asarray(planes), jnp.asarray(base), width, 2)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    back = (_u32(got)[0].astype(np.uint64) << np.uint64(32)) \
        | _u32(got)[1].astype(np.uint64)
    np.testing.assert_array_equal(back, keys)
    if width:
        assert (keys[0] >= 1 << 63).any() and (keys[0] < 1 << 63).any()
        assert (np.abs(np.diff(keys[1].astype(object))) > 1 << 63).any()


def _rle_case(rng, k, nruns):
    ends = np.full((P, k), 0xFFFFFFFF, np.uint32)
    for p in range(P):
        r = nruns[p]
        cuts = np.sort(rng.choice(np.arange(1, N), r - 1, replace=False))
        ends[p, :r] = np.concatenate([cuts, [N]])
    return ends


@pytest.mark.parametrize("k,nruns", [(1, (1, 1, 1)), (8, (3, 8, 1)),
                                     (N, (N, 2, 100))])
def test_rle_decodes(rng, k, nruns):
    ends = _rle_case(rng, k, nruns)
    for L in (1, 2, 4):
        values = rng.integers(0, 1 << 32, (P, L, k), dtype=np.uint64) \
            .astype(np.uint32)
        np.testing.assert_array_equal(
            _u32(TS.decode_rle(_words(values), _words(ends), N)),
            np.asarray(RS.decode_rle(jnp.asarray(values), jnp.asarray(ends),
                                     N)))
    idx = TS.rle_run_index(_words(ends), N)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(RS.rle_run_index(jnp.asarray(ends), N)))
    run_mask = rng.random((P, k)) < 0.5
    np.testing.assert_array_equal(
        TS.rle_gather_mask(_words(ends), torch.from_numpy(run_mask),
                           N).numpy(),
        np.asarray(RS.rle_gather_mask(jnp.asarray(ends),
                                      jnp.asarray(run_mask), N)))


@pytest.mark.parametrize("width", [1, 8, 12, 31, 32])
def test_dict_decodes(rng, width):
    k = 1 << min(width, 9)
    codes = rng.integers(0, k, (P, N), dtype=np.uint64)
    planes = _planes(codes, width)
    for L in (1, 2, 4):
        values = rng.integers(0, 1 << 32, (P, L, k), dtype=np.uint64) \
            .astype(np.uint32)
        np.testing.assert_array_equal(
            _u32(TS.decode_dict(_words(planes), _words(values), width)),
            np.asarray(RS.decode_dict(jnp.asarray(planes),
                                      jnp.asarray(values), width)))
    dmask = rng.random((P, k)) < 0.5
    np.testing.assert_array_equal(
        TS.dict_gather_mask(_words(planes), width,
                            torch.from_numpy(dmask)).numpy(),
        np.asarray(RS.dict_gather_mask(jnp.asarray(planes), width,
                                       jnp.asarray(dmask))))
