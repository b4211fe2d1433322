"""knoxdb_tpu_torch's salted shuffle join on a mesh of eight CPU shards
against the reference's shuffle_join_rows on its 8-device virtual CPU
mesh: the eleven cases of tests/test_parallel.py (rows, skew, unique
build inner / left, unique with skew, the unique dup fallback, the shift
core, the shift fallback, keys32 both ways, LEFT). Pairs are equal as
multisets (pair order is unspecified), and so are the ladder's decisions:
`core`, `heavy_buckets`, the tile caps `cap_exchange`, the pair cap
`cap_pairs` and the rows each shard received. `_bucket` is held to the
reference bit for bit."""

import numpy as np
import pytest
import torch

from knoxdb_tpu.exec.join import join_keys_np
from knoxdb_tpu.parallel import shuffle as RSH
from knoxdb_tpu.types import JoinType
from knoxdb_tpu_torch.parallel import Mesh
from knoxdb_tpu_torch.parallel import shuffle as TSH

NDEV = 8
CPU8 = Mesh([torch.device("cpu")] * NDEV, ("shards",))


def _ref_mesh():
    import jax
    from jax.sharding import Mesh as JMesh
    return JMesh(np.array(jax.devices()[:NDEV]), ("shards",))


def _oracle(rng):
    nl, nr = 100_000, 20_000
    rk = rng.permutation(np.arange(1, nr + 1)).astype(np.uint64)
    lk = rng.integers(1, nr * 2, nl).astype(np.uint64)
    return lk, rk, {}


def _skew_salted(rng):
    nl = 50_000
    hot = np.uint64(777)
    lk = rng.integers(1, 1000, nl).astype(np.uint64)
    lk[: nl * 2 // 5] = hot
    rk = np.concatenate([np.arange(1, 1000, dtype=np.uint64),
                         np.full(3, hot, np.uint64)])
    return lk, rk, {"skew_factor": 2.0}


def _unique(how):
    def case(rng):
        nl, nr = 60_000, 9_000
        rk = rng.permutation(np.arange(1, nr + 1)).astype(np.uint64)
        lk = rng.integers(1, nr * 2, nl).astype(np.uint64)
        return lk, rk, {"how": how, "unique_build": True}
    return case


def _unique_skew(rng):
    nl = 40_000
    hot = np.uint64(777)
    lk = rng.integers(1, 1000, nl).astype(np.uint64)
    lk[: nl * 2 // 5] = hot
    rk = rng.permutation(np.arange(1, 1000)).astype(np.uint64)
    return lk, rk, {"skew_factor": 2.0, "unique_build": True}


def _unique_dup_fallback(rng):
    rk = np.concatenate([np.arange(1, 2000, dtype=np.uint64),
                         np.array([7, 7], np.uint64)])
    lk = rng.integers(1, 3000, 10_000).astype(np.uint64)
    return lk, rk, {"unique_build": True}


def _shift_core(rng):
    lk = rng.integers(1, 13_333, 40_000).astype(np.uint64)
    rk = rng.integers(1, 13_333, 16_000).astype(np.uint64)
    return lk, rk, {}


def _shift_fallback(rng):
    rk = np.concatenate([np.arange(1, 2000, dtype=np.uint64),
                         np.full(40, 7, np.uint64)])      # 41-wide run
    lk = rng.integers(1, 3000, 20_000).astype(np.uint64)
    return lk, rk, {}


def _keys32(unique):
    def case(rng):
        nr = 9_000
        rk = rng.permutation(np.arange(1, nr + 1)).astype(np.uint64)
        if not unique:
            rk = np.concatenate([rk, rk[:500]])
        lk = rng.integers(1, nr * 2, 30_000).astype(np.uint64)
        return lk, rk, {"unique_build": unique, "keys32": True}
    return case


def _left(rng):
    lk = rng.integers(1, 200, 5000).astype(np.uint64)
    rk = np.arange(1, 100, dtype=np.uint64)
    return lk, rk, {"how": "left"}


CASES = {"oracle": (_oracle, None), "skew_salted": (_skew_salted, None),
         "unique_inner": (_unique("inner"), "unique"),
         "unique_left": (_unique("left"), "unique"),
         "unique_skew": (_unique_skew, None),
         "unique_dup_fallback": (_unique_dup_fallback, None),
         "shift_core": (_shift_core, "shift"),
         "shift_fallback": (_shift_fallback, "general"),
         "keys32_dups": (_keys32(False), "shift"),
         "keys32_unique": (_keys32(True), "unique"),
         "left": (_left, None)}


def _pairs(lidx, ridx):
    return sorted(zip(lidx.tolist(), ridx.tolist()))


@pytest.mark.parametrize("name", list(CASES))
def test_shuffle_join_rows_equals_reference(name):
    make, core = CASES[name]
    lk, rk, kw = make(np.random.default_rng(0xC0FFEE))
    rl, rr, rs = RSH.shuffle_join_rows(_ref_mesh(), lk, rk, **kw)
    tl, tr, ts = TSH.shuffle_join_rows(CPU8, lk, rk, **kw)
    assert _pairs(tl, tr) == _pairs(rl, rr)
    for key in ("core", "heavy_buckets", "cap_exchange", "cap_pairs",
                "ndev", "shuffle_bytes", "work_eff", "rows_per_dev"):
        assert ts[key] == (list(rs[key]) if key == "rows_per_dev"
                           else rs[key]), key
    if core is not None:
        assert ts["core"] == core
    how = JoinType[kw.get("how", "inner").upper()]
    want = join_keys_np(lk, rk, how)
    assert _pairs(tl, tr) == _pairs(want.lidx, want.ridx)


def test_shuffle_join_rows_takes_device_keys():
    """Keys as int64 tensors of u64 bits (as Table.join_side gives them),
    top bits set included, give the numpy call's pairs."""
    rng = np.random.default_rng(5)
    rk = rng.permutation(np.arange(1, 3001)).astype(np.uint64) \
        | np.uint64(1 << 63)
    lk = rng.choice(rk, 7000)
    a = TSH.shuffle_join_rows(CPU8, lk, rk, unique_build=True)
    b = TSH.shuffle_join_rows(CPU8, torch.from_numpy(lk.view(np.int64)),
                              torch.from_numpy(rk.view(np.int64)),
                              unique_build=True)
    assert _pairs(a[0], a[1]) == _pairs(b[0], b[1])
    assert a[2]["core"] == b[2]["core"] == "unique"


def test_shuffle_join_checksum():
    """The round-1 helper: (matches, checksum of lval + rval mod 2^64)."""
    rng = np.random.default_rng(0xC0FFEE)
    nl, nr = NDEV * 400, NDEV * 100
    rkeys = rng.permutation(np.arange(1, nr + 1, dtype=np.uint64))
    rvals = rng.integers(0, 1000, nr, dtype=np.uint64)
    lkeys = rng.integers(1, nr * 2, nl, dtype=np.uint64)
    lvals = rng.integers(0, 1000, nl, dtype=np.uint64)
    cnt, csum = TSH.shuffle_join(CPU8, lkeys, lvals, rkeys, rvals,
                                 skew_factor=8.0)
    rmap = {int(k): int(v) for k, v in zip(rkeys, rvals)}
    hits = [int(lv) + rmap[int(k)] for k, lv in zip(lkeys, lvals)
            if int(k) in rmap]
    assert (cnt, csum) == (len(hits), sum(hits) % (1 << 64))


@pytest.mark.parametrize("ndev", [1, 3, 8, 1024])
def test_bucket_bit_for_bit(ndev):
    import jax.numpy as jnp
    rng = np.random.default_rng(ndev)
    keys = np.concatenate([
        np.array([0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 63, 2 ** 63 + 1,
                  2 ** 64 - 1], np.uint64),
        rng.integers(0, 2 ** 64 - 1, 4096, dtype=np.uint64, endpoint=True)])
    want = np.asarray(RSH._bucket(jnp.asarray(keys), ndev))
    got = TSH._bucket(torch.from_numpy(keys.view(np.int64)), ndev).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
