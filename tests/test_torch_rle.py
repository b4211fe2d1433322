"""RLE run expansion of knoxdb_tpu_torch/exec/device.py (rle_row_runs,
rle_expand_mask, rle_expand_values) against knoxdb_tpu/exec/device.py and a
numpy oracle, on the same seeded inputs: one run, N runs, padded runs.

Integers only, so the tolerance is 0. One case is a recorded divergence:
the reference's rle_row_runs adds the u32 start of a padded run to the
pack's row offset and the sum wraps, so a pack with two or more padded
runs puts a count on the LAST row of the pack before it (ROADMAP.md
section 3); the port drops padded runs as the reference's own comment
says, and is held to the oracle there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knoxdb_tpu.exec import device as RD
from knoxdb_tpu_torch.exec import device as TD
from knoxdb_tpu_torch.ops import words as WD

N = 128


def _ends(rng, runs_per_pack, k):
    ends = np.full((len(runs_per_pack), k), 0xFFFFFFFF, np.uint32)
    for p, r in enumerate(runs_per_pack):
        cuts = np.sort(rng.choice(np.arange(1, N), r - 1, replace=False))
        ends[p, :r] = np.concatenate([cuts, [N]])
    return ends


def _oracle_runs(ends):
    row = np.arange(N)
    return (ends[:, :, None].astype(np.int64) <= row).sum(axis=1)


# (runs per pack, k): one run; N runs; runs padded to k. Every pack after
# the first has at most one padded run, where the reference is right.
CASES = [((1,), 1), ((1, 1, 1), 1), ((N, N), N), ((5, 7, 8, 7), 8),
         ((3, 4), 4), ((40, 63, 64), 64)]


@pytest.mark.parametrize("runs,k", CASES)
def test_rle_row_runs(rng, runs, k):
    ends = _ends(rng, runs, k)
    got = TD.rle_row_runs(WD.to_words(ends, "cpu"), N)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _oracle_runs(ends))
    want = RD.rle_row_runs(jnp.asarray(ends), N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rle_row_runs_padded_divergence(rng):
    """Two or more padded runs in a pack after the first: the port equals
    the oracle; the reference differs, and only on the last row of the
    pack before (the recorded divergence)."""
    ends = _ends(rng, (3, 5, 2), 8)
    got = TD.rle_row_runs(WD.to_words(ends, "cpu"), N).numpy()
    np.testing.assert_array_equal(got, _oracle_runs(ends))
    ref = np.asarray(RD.rle_row_runs(jnp.asarray(ends), N))
    diff = np.argwhere(ref != got)
    assert {tuple(d) for d in diff} == {(0, N - 1), (1, N - 1)}
    # the group decode that runs it returns each row's run value
    values = rng.integers(0, 1 << 32, (3, 2, 8), dtype=np.uint64) \
        .astype(np.uint32)
    g = TD.DeviceGroup(TD.Scheme.RLE, 0, 8, 2, False, np.arange(3))
    g.arrays = {"values": WD.to_words(values, "cpu"),
                "ends": WD.to_words(ends, "cpu")}
    lim = WD.from_words(TD.group_decode_limbs(g, N // 32))
    runs = _oracle_runs(ends)
    for p in range(3):
        np.testing.assert_array_equal(lim[:, p], values[p][:, runs[p]])


@pytest.mark.parametrize("runs,k", CASES + [((3, 5, 2), 8)])
def test_rle_expand_mask(rng, runs, k):
    ends = _ends(rng, runs, k)
    run_mask = rng.random(ends.shape) < 0.5
    got = TD.rle_expand_mask(WD.to_words(ends, "cpu"),
                             torch.from_numpy(run_mask), N)
    assert got.dtype == torch.bool
    runs_of = _oracle_runs(ends)
    want = np.take_along_axis(run_mask, runs_of, axis=1)
    np.testing.assert_array_equal(got.numpy(), want)
    ref = RD.rle_expand_mask(jnp.asarray(ends), jnp.asarray(run_mask), N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("runs,k", CASES + [((3, 5, 2), 8)])
def test_rle_expand_values(rng, runs, k):
    """Run values across the whole u64 range: the differences and the
    prefix sum wrap mod 2^64."""
    ends = _ends(rng, runs, k)
    rv = rng.integers(0, 1 << 64, ends.shape, dtype=np.uint64)
    rv[:, 0] = (1 << 64) - 1
    got = TD.rle_expand_values(
        WD.to_words(ends, "cpu"),
        torch.from_numpy(WD.bits_from_u64(rv)), N)
    assert got.dtype == torch.int64
    got = got.numpy().view(np.uint64)
    np.testing.assert_array_equal(
        got, np.take_along_axis(rv, _oracle_runs(ends), axis=1))
    ref = RD.rle_expand_values(jnp.asarray(ends), jnp.asarray(rv), N)
    np.testing.assert_array_equal(got, np.asarray(ref))
