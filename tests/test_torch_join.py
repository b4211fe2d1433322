"""knoxdb_tpu_torch.exec.join against knoxdb_tpu.exec.join.

Every sort of the reference's join has one deterministic result (distinct
composite keys, or ties kept in input order by XLA's stable sort), so the
port's cores equal the reference's ARRAY FOR ARRAY, the -2 padding and the
interspersed order included; the filtered pairs also equal join_keys_np's
as multisets. Keys are made with numpy and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knoxdb_tpu.exec import device as RD
from knoxdb_tpu.exec import join as RJ
from knoxdb_tpu.exec.device import DeviceSegment as RDevSeg
from knoxdb_tpu.pack.segment import build_segment as r_build
from knoxdb_tpu.schema.schema import Builder as RBuilder
from knoxdb_tpu.types import FieldType as RFT
from knoxdb_tpu.types import JoinType as RJT
from knoxdb_tpu_torch.exec import device as TD
from knoxdb_tpu_torch.exec import join as TJ
from knoxdb_tpu_torch.exec.device import DeviceSegment as TDevSeg
from knoxdb_tpu_torch.pack.segment import segment_from_reference
from knoxdb_tpu_torch.types import JoinType as TJT

TOP32 = (1 << 32) - 1
HOWS = [0, 1]                 # INNER, LEFT


def _t(a):
    """Host u64 keys -> the port's int64 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def _eq(ref, got, what):
    r = np.asarray(ref)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert r.shape == g.shape, (what, r.shape, g.shape)
    np.testing.assert_array_equal(g.astype(np.int64), r.astype(np.int64),
                                  err_msg=str(what))


def _same_outputs(ref, got, what):
    assert len(ref) == len(got)
    for i, (r, g) in enumerate(zip(ref, got)):
        _eq(r, g, (what, i))


def _pairs(li, ri):
    li, ri = np.asarray(li), np.asarray(ri)
    keep = li != -2
    return sorted(zip(li[keep].tolist(), ri[keep].tolist()))


def _oracle(lk, rk, how):
    w = RJ.join_keys_np(lk, rk, RJT(how))
    return sorted(zip(w.lidx.tolist(), w.ridx.tolist()))


def _keys(rng, nl, nr, krange, keys32):
    """Random keys with a probe miss at index 0; without keys32 also keys
    at 2^64 - 1 and 2^63 (the top of the u64 order and the sign bit)."""
    lk = rng.integers(0, krange, nl, dtype=np.uint64)
    rk = rng.integers(0, krange, nr, dtype=np.uint64)
    lk[0] = krange + 5
    top = TOP32 if keys32 else (1 << 64) - 1
    lk[1] = rk[0] = top
    if not keys32:
        rk[1] = lk[2] = 1 << 63
    return lk, rk


# few shapes: the reference runs op by op and compiles each op once per
# shape, so the cases share theirs
CASES = [(100, 73, 40), (73, 100, 1000)]


@pytest.mark.parametrize("how", [0, 1, 2, 3, 4])
def test_join_keys_np_equals_reference(rng, how):
    for nl, nr, kr in [(300, 200, 50), (50, 400, 1000), (10, 10, 1)]:
        lk, rk = _keys(rng, nl, nr, kr, False)
        want = RJ.join_keys_np(lk, rk, RJT(how))
        got = TJ.join_keys_np(lk, rk, TJT(how))
        _eq(want.lidx, got.lidx, ("lidx", how))
        _eq(want.ridx, got.ridx, ("ridx", how))
        assert got.lidx.dtype == got.ridx.dtype == np.int64
    empty = np.zeros(0, np.uint64)
    for lk, rk in ((empty, np.arange(3, dtype=np.uint64)),
                   (np.arange(3, dtype=np.uint64), empty)):
        want = RJ.join_keys_np(lk, rk, RJT(how))
        got = TJ.join_keys_np(lk, rk, TJT(how))
        _eq(want.lidx, got.lidx, "empty")
        _eq(want.ridx, got.ridx, "empty")


@pytest.mark.parametrize("n", [1, 1024, 1025, 5000, (1 << 20) + 7])
def test_fill_forward(rng, n):
    """The running maximum (blocked in rows of 1024 past that length) and
    the forward fill against numpy, and against the reference's
    log-doubling versions where they are cheap to run."""
    vals = rng.integers(-(1 << 40), 1 << 40, n)
    got = TJ._fill_forward_max(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, np.maximum.accumulate(vals))
    sent = 0xFFFFFFFF
    sparse = np.where(rng.random(n) < 0.01, vals & 0xFFFF, sent)
    sparse[0] = sent
    has = sparse != sent
    last = np.maximum.accumulate(np.where(has, np.arange(n), -1))
    want = np.where(last >= 0, sparse[np.maximum(last, 0)], sent)
    got = TJ._fill_forward_last(torch.from_numpy(sparse), sent).numpy()
    np.testing.assert_array_equal(got, want)
    if n == 1025:
        _eq(RJ._fill_forward_max(jnp.asarray(vals)),
            TJ._fill_forward_max(torch.from_numpy(vals)), "max")
        _eq(RJ._fill_forward_last(jnp.asarray(sparse.astype(np.uint32)),
                                  jnp.uint32(sent)), got, "last")


@pytest.mark.parametrize("na,nb", [(0, 64), (64, 0), (100, 28), (7, 250),
                                   (1, 1)])
def test_merge_sorted_stable(rng, na, nb):
    a = np.sort(rng.integers(0, 40, na)).astype(np.uint32)
    b = np.sort(rng.integers(0, 40, nb)).astype(np.uint32)
    key = np.concatenate([a, b])
    pays = [rng.integers(0, 1 << 31, na + nb).astype(np.uint32)
            for _ in range(2)]
    ref = RJ.merge_sorted_stable(na, jnp.asarray(key),
                                 *(jnp.asarray(p) for p in pays))
    got = TJ.merge_sorted_stable(na, torch.from_numpy(key.astype(np.int64)),
                                 *(torch.from_numpy(p.astype(np.int64))
                                   for p in pays))
    _same_outputs(ref, got, "merge")


@pytest.mark.parametrize("keys32", [False, True])
def test_merged_sort_tagged(rng, keys32):
    lk, rk = _keys(rng, 100, 73, 40, keys32)
    ks, pidt = RJ._merged_sort_tagged(jnp.asarray(lk), jnp.asarray(rk),
                                      keys32)
    (tk,), tpidt = TJ._merged_sort_tagged(_t(lk), _t(rk), keys32)
    _eq(pidt, tpidt, "pidt")
    if keys32:
        _eq(ks[0], tk, "key lo")
    else:
        bits = tk.numpy().view(np.uint64) ^ np.uint64(1 << 63)
        _eq(ks[0], bits >> np.uint64(32), "key hi")
        _eq(ks[1], bits & np.uint64(TOP32), "key lo")


def test_probe_bounds_merged(rng):
    lk, rk = _keys(rng, 100, 73, 60, False)
    rs = np.sort(rk)
    halves = [(a >> np.uint64(32)).astype(np.uint32) for a in (rs, lk)]
    lows = [(a & np.uint64(TOP32)).astype(np.uint32) for a in (rs, lk)]
    ref = RJ._probe_bounds_merged(jnp.asarray(halves[0]),
                                  jnp.asarray(lows[0]),
                                  jnp.asarray(halves[1]),
                                  jnp.asarray(lows[1]))
    got = TJ._probe_bounds_merged(*(torch.from_numpy(x.view(np.int32))
                                    for x in (halves[0], lows[0], halves[1],
                                              lows[1])))
    _same_outputs(ref, got, "bounds")
    assert got[0].dtype == got[1].dtype == torch.int32


@pytest.mark.parametrize("L", [1, 2, 3])
def test_probe_bounds_merged_limbs(rng, L):
    b = rng.integers(0, 3, (L, 150)).astype(np.uint32)
    q = rng.integers(0, 3, (L, 90)).astype(np.uint32)
    b[0, :5] = q[0, :3] = 0xFFFFFFFF                # the unsigned top
    ref = RJ._probe_bounds_merged_limbs([jnp.asarray(x) for x in b],
                                        [jnp.asarray(x) for x in q])
    got = TJ._probe_bounds_merged_limbs(
        [torch.from_numpy(x.view(np.int32)) for x in b],
        [torch.from_numpy(x.view(np.int32)) for x in q])
    _same_outputs(ref, got, ("limbs", L))


@pytest.mark.parametrize("keys32", [False, True])
@pytest.mark.parametrize("how", HOWS)
def test_shift_core(rng, how, keys32):
    for nl, nr, kr in CASES:
        lk, rk = _keys(rng, nl, nr, kr, keys32)
        ref = RJ.join_pairs_core_shift(jnp.asarray(lk), jnp.asarray(rk), S=16,
                                       how=RJT(how), keys32=keys32)
        got = TJ.join_pairs_core_shift(_t(lk), _t(rk), S=16, how=TJT(how),
                                       keys32=keys32)
        _same_outputs(ref, got, ("shift", nl, how, keys32))
        assert [t.dtype for t in got] == [torch.int32, torch.int32,
                                          torch.int64, torch.int32]
        assert int(got[3]) <= 16
        assert _pairs(got[0], got[1]) == _oracle(lk, rk, how)


@pytest.mark.parametrize("keys32", [False, True])
@pytest.mark.parametrize("how", HOWS)
def test_expansion_core(rng, how, keys32):
    """At a cap that holds every pair and at one that cuts them: total is
    the true count either way."""
    for nl, nr, kr in CASES:
        lk, rk = _keys(rng, nl, nr, kr, keys32)
        want = _oracle(lk, rk, how)
        for cap in (256, 64):
            ref = RJ.join_pairs_core(jnp.asarray(lk), jnp.asarray(rk), cap,
                                     RJT(how), keys32=keys32)
            got = TJ.join_pairs_core(_t(lk), _t(rk), cap, TJT(how),
                                     keys32=keys32)
            _same_outputs(ref, got, ("core", nl, cap, how, keys32))
            assert [t.dtype for t in got] == [torch.int32, torch.int32,
                                              torch.int64]
            assert int(got[2]) == len(want)
            if cap >= len(want):
                assert _pairs(got[0], got[1]) == want


@pytest.mark.parametrize("keys32", [False, True])
@pytest.mark.parametrize("how", HOWS)
def test_unique_core(rng, how, keys32):
    for nl, nr, kr in [(100, 73, 400), (73, 1, 4)]:
        lk = rng.integers(0, kr, nl, dtype=np.uint64)
        rk = rng.choice(kr, nr, replace=False).astype(np.uint64)
        lk[0] = kr + 5
        lk[1] = rk[0] = TOP32 if keys32 else (1 << 64) - 1
        ref = RJ.join_pairs_core_unique(jnp.asarray(lk), jnp.asarray(rk),
                                        RJT(how), keys32=keys32)
        got = TJ.join_pairs_core_unique(_t(lk), _t(rk), TJT(how),
                                        keys32=keys32)
        _same_outputs(ref, got, ("unique", nl, how, keys32))
        assert not bool(got[3])
        assert _pairs(got[0], got[1]) == _oracle(lk, rk, how)
    # a duplicated build key sets dup_builds
    rk = np.array([3, 7, 7, 9], np.uint64)
    lk = np.array([7, 3, 11], np.uint64)
    ref = RJ.join_pairs_core_unique(jnp.asarray(lk), jnp.asarray(rk),
                                    RJT(how), keys32=keys32)
    got = TJ.join_pairs_core_unique(_t(lk), _t(rk), TJT(how), keys32=keys32)
    _same_outputs(ref, got, "dup build")
    assert bool(got[3])


@pytest.mark.parametrize("how", HOWS)
def test_join_count_device(rng, how):
    for nl, nr, kr in CASES + [(100, 73, 1)]:
        lk, rk = _keys(rng, nl, nr, kr, False)
        ref = RJ.join_count_device(jnp.asarray(lk), jnp.asarray(rk), RJT(how))
        got = TJ.join_count_device(_t(lk), _t(rk), TJT(how))
        assert int(got) == int(ref) == len(_oracle(lk, rk, how))
        assert got.dtype == torch.int64


def _device_cases(rng):
    """(name, lkeys, rkeys): a shift-core case at the 2^32 - 1 boundary, a
    duplicate build key (the unique rung falls back), a key run wider than
    SHIFT_S (the shift rung falls back to the expansion core) and keys
    that match nothing."""
    lk, rk = _keys(rng, 100, 73, 500, True)
    lk[:5] = TOP32
    rk[:2] = TOP32
    yield "boundary", lk, rk
    rk = rng.choice(1000, 73, replace=False).astype(np.uint64)
    rk[1] = rk[0]
    yield "dup build", rng.integers(0, 1000, 100, dtype=np.uint64), rk
    lk = np.concatenate([np.full(10, 7, np.uint64),
                         rng.integers(100, 200, 90, dtype=np.uint64)])
    rk = np.concatenate([np.full(30, 7, np.uint64),
                         rng.integers(100, 200, 43, dtype=np.uint64)])
    yield "wide run", lk, rk
    yield "no match", np.arange(100, dtype=np.uint64) + 1000, \
        np.arange(73, dtype=np.uint64)


@pytest.mark.parametrize("keys32", [False, True])
@pytest.mark.parametrize("how", HOWS)
def test_join_pairs_device(rng, how, keys32):
    for name, lk, rk in _device_cases(rng):
        for unique in (False, True):
            ref = RJ.join_pairs_device(jnp.asarray(lk), jnp.asarray(rk),
                                       RJT(how), unique_build=unique,
                                       keys32=keys32)
            got = TJ.join_pairs_device(_t(lk), _t(rk), TJT(how),
                                       unique_build=unique, keys32=keys32)
            _same_outputs(ref, got, (name, how, keys32, unique))
            assert got[0].dtype == got[1].dtype == np.int64
            assert sorted(zip(got[0].tolist(), got[1].tolist())) \
                == _oracle(lk, rk, how)


@pytest.mark.parametrize("how", HOWS)
def test_join_pairs_device_empty_sides(how):
    some = np.arange(5, dtype=np.uint64)
    none = np.zeros(0, np.uint64)
    for lk, rk in ((none, some), (some, none)):
        ref = RJ.join_pairs_device(jnp.asarray(lk), jnp.asarray(rk), RJT(how))
        got = TJ.join_pairs_device(_t(lk), _t(rk), TJT(how))
        _same_outputs(ref, got, "empty")
    with pytest.raises(TypeError):
        TJ.join_pairs_device(torch.zeros(3, dtype=torch.int32), _t(some))


def test_join_side_key_domains(rng):
    """The join-side key of table.join_side: the reference decodes keyform
    u64 and flips bit 63 of signed fields (two's-complement value domain);
    the port's group_decode_keys gives ordered int64 keys (keyform with
    bit 63 flipped), so an unsigned field flips it back and a signed field
    keeps it. Both domains equal the reference's bits, and an INT64 fk
    joins a UINT64 pk by numeric value."""
    n = 2048 * 4
    acct = rng.integers(-1000, 1000, n).astype(np.int64)
    data = {"id": np.arange(1, n + 1, dtype=np.uint64), "acct": acct,
            "u": rng.integers(0, 1 << 20, n, dtype=np.uint64)
            + np.uint64(1 << 63)}
    sch = (RBuilder("s").pk("id").add("acct", RFT.INT64)
           .add("u", RFT.UINT64).finish())
    rseg = r_build(sch, data, pack_size=2048)
    rd, td = RDevSeg(rseg), TDevSeg(segment_from_reference(rseg), "cpu")
    dom = {}
    for name, signed in (("acct", True), ("u", False)):
        rg, tg = rd.column(name).groups[0], td.column(name).groups[0]
        flip = np.uint64(1 << 63) if signed else np.uint64(0)
        want = np.asarray(RD.group_decode_keys(rg.sig(), rg.arrays, rd.W)) \
            .reshape(-1) ^ flip
        keys = TD.group_decode_keys(tg, td.W).reshape(-1)
        if not signed:
            keys = keys ^ (-(1 << 63))
        np.testing.assert_array_equal(keys.numpy().view(np.uint64), want)
        dom[name] = keys
    np.testing.assert_array_equal(dom["acct"].numpy(), acct)
    pk = np.array([0, 7, (1 << 64) - 1, (1 << 64) - 5, 1 << 63],
                  np.uint64)                                  # -1, -5
    for how in HOWS:
        ref = RJ.join_pairs_device(jnp.asarray(acct.view(np.uint64)),
                                   jnp.asarray(pk), RJT(how),
                                   unique_build=True)
        got = TJ.join_pairs_device(dom["acct"], _t(pk), TJT(how),
                                   unique_build=True)
        _same_outputs(ref, got, ("fk-pk", how))
        assert len(got[0]) > 0
