"""The chunk kernel's plain version against the reference's Pallas kernel
(knoxdb_tpu.ops.pallas_group.fused_group_partials in interpret mode, the
probes' v0: the same output contract at the same (H, L, shift, C, S)) and
against copies of the group probes' numpy oracles; and the chunk route
exec/groupby.group_count_chunks against the reference's _group_pallas and
the port's exact-halves route group_count_sum.

The probes' own kernels (probes/pg3_variants.py k_v1 / k_v2 / k_v3 /
make_call, probes/pg_bigG.py k_loop / k_vec / k_chunk) are closures inside
their main() and cannot be imported; each is this one function at another
geometry, tile height, output type or column layout. On the CPU the wrapper
runs its plain version; the CUDA kernel is held against the same plain
version on the card (tests/test_torch_cuda_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knoxdb_tpu.exec import groupby as RGB
from knoxdb_tpu.ops import pallas_group as PG
from knoxdb_tpu_torch.exec import groupby as TGB
from knoxdb_tpu_torch.ops import bitset as TBS
from knoxdb_tpu_torch.ops import group_chunk_kernels as GCK
from knoxdb_tpu_torch.ops import words as WD

GEO6 = (128, 8, 3, 4)        # probes/pg3_variants.py: H, L, shift, C
GEO7 = (256, 32, 5, 6)       # probes/pg_bigG.py


def oracle_pg3(gid, vlo, vhi, H, L, C):
    """Copy of probes/pg3_variants.py oracle: counts and per-chunk byte
    sums per h * L + l, python-int exact."""
    NC = C + 1
    out = np.zeros((H * L, NC), dtype=object)
    v = vlo.astype(object)
    if C > 4:
        v = v + (vhi.astype(object) << 32)
    np.add.at(out[:, C], gid, 1)
    for c in range(C):
        np.add.at(out[:, c], gid, (v >> (8 * c)) & 0xFF)
    return out


def oracle_bigG(gid, vlo, vhi, G, C):
    """Copy of probes/pg_bigG.py oracle."""
    out = np.zeros((G, C + 1), dtype=object)
    v = vlo.astype(object) + (vhi.astype(object) << 32)
    np.add.at(out[:, C], gid, 1)
    for c in range(C):
        np.add.at(out[:, c], gid, (v >> (8 * c)) & 0xFF)
    return out


def _inputs(rng, n, G, C, lo=0, extra=0):
    """gid in [lo, G + extra) and value halves that fill C byte chunks."""
    gid = rng.integers(lo, G + extra, n).astype(np.int32)
    vlo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    hb = max(0, 8 * (C - 4))
    vhi = rng.integers(0, 1 << hb, n, dtype=np.uint64).astype(np.uint32) \
        if hb else np.zeros(n, np.uint32)
    return gid, vlo, vhi


def _port(gid, vlo, vhi, H, L, shift, C, **kw):
    before = GCK.PLAIN_CALLS["group_chunk_partials"]
    out = GCK.group_chunk_partials(
        torch.from_numpy(gid), WD.to_words(vlo, "cpu"),
        WD.to_words(vhi, "cpu"), H, L, shift, C, **kw)
    assert GCK.PLAIN_CALLS["group_chunk_partials"] == before + 1
    return out


@pytest.mark.parametrize("S", [8, 16, 32])
@pytest.mark.parametrize("geo", [GEO6, GEO7], ids=["pg3", "bigG"])
def test_plain_equals_pallas_interpret(geo, S):
    """Bit-identical with the reference kernel after the cast to int, rows
    past the last block's end included (the reference pads with its
    sentinel; the port cuts the last block short)."""
    H, L, shift, C = geo
    rng = np.random.default_rng(H + S)
    n = S * 1024 * 2 + 1024
    G = H * L
    gid, vlo, vhi = _inputs(rng, n, G, C, extra=40)     # some gid >= H * L
    want = np.asarray(PG.fused_group_partials(
        jnp.asarray(gid), jnp.asarray(vlo), jnp.asarray(vhi), G, L, shift,
        n_chunks=C, interpret=True, H=H, S=S))
    got = _port(gid, vlo, vhi, H, L, shift, C, S=S)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  want.astype(np.int64))


@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("S", [8, 16, 32])
def test_pg3_oracle(S, out_dtype, band):
    """G = 1000 at the pg3 geometry: f32 (k_v1, k_v3, make_call) and i32
    (k_v2, whose output is the plain sum) outputs, both layouts."""
    H, L, shift, C = GEO6
    rng = np.random.default_rng(7 + S)
    n = 32 * 1024 * 2
    gid, vlo, vhi = _inputs(rng, n, 1000, C)
    want = oracle_pg3(gid, vlo, vhi, H, L, C)
    parts = _port(gid, vlo, vhi, H, L, shift, C, S=S, out_dtype=out_dtype,
                  band=band)
    assert parts.dtype == out_dtype
    assert tuple(parts.shape) == (n // (S * 1024), H, L * (C + 1))
    if band:
        parts = GCK.unband(parts, L)
    acc = parts.to(torch.int64).sum(0).reshape(H * L, C + 1).numpy()
    assert (acc.astype(object) == want).all()


@pytest.mark.parametrize("band", [False, True])
def test_bigG_oracle_single_pass(band):
    """G = 8192 at the bigG geometry, k_loop / k_vec (interleaved) and
    k_chunk (band, un-permuted as the probe's acc_of does)."""
    H, L, shift, C = GEO7
    rng = np.random.default_rng(11)
    n = 8 * 1024 * 3
    gid, vlo, vhi = _inputs(rng, n, 8192, C)
    want = oracle_bigG(gid, vlo, vhi, 8192, C)
    parts = _port(gid, vlo, vhi, H, L, shift, C, band=band)
    if band:
        a3 = parts.to(torch.int64).sum(0).reshape(H, C + 1, L)
        acc = a3.transpose(1, 2).reshape(H * L, C + 1)
        assert torch.equal(GCK.unband(parts, L).to(torch.int64).sum(0)
                           .reshape(H * L, C + 1), acc)
    else:
        acc = parts.to(torch.int64).sum(0).reshape(H * L, C + 1)
    assert (acc.numpy().astype(object) == want).all()


def test_bigG_eight_passes():
    """G = 65,536: pass p runs the same launch on gid - p * 8192; rows
    outside the pass have a negative or too large hi index and drop."""
    H, L, shift, C = GEO7
    rng = np.random.default_rng(12)
    n = 8 * 1024 * 4
    gid, vlo, vhi = _inputs(rng, n, 65536, C)
    want = oracle_bigG(gid, vlo, vhi, 65536, C)
    accs = []
    for p in range(8):
        parts = _port((gid - p * 8192).astype(np.int32), vlo, vhi, H, L,
                      shift, C, band=True)
        accs.append(GCK.unband(parts, L).to(torch.int64).sum(0)
                    .reshape(H * L, C + 1))
    acc = torch.cat(accs).numpy()
    assert (acc.astype(object) == want).all()


def test_negative_and_sentinel_gids_drop():
    H, L, shift, C = GEO6
    rng = np.random.default_rng(3)
    n = 8 * 1024
    gid, vlo, vhi = _inputs(rng, n, 1000, C, lo=-3000, extra=3000)
    gid[:5] = [-1, -(1 << 31), (1 << 31) - 1, H * L, H * L - 1]
    ok = (gid >= 0) & (gid < H * L)
    want = oracle_pg3(gid[ok], vlo[ok], vhi[ok], H, L, C)
    for out_dtype in (torch.float32, torch.int32):
        parts = _port(gid, vlo, vhi, H, L, shift, C, out_dtype=out_dtype)
        acc = parts.to(torch.int64).sum(0).reshape(H * L, C + 1).numpy()
        assert (acc.astype(object) == want).all()


def test_full_block_of_one_group_is_exact_in_f32():
    """The largest entry a block can hold: S * 1024 rows of byte 255 in one
    cell, 8,355,840 at S = 32, exact in float32."""
    H, L, shift, C = GEO6
    S = 32
    n = S * 1024
    gid = np.full(n, 999, np.int32)
    vlo = np.full(n, 0xFFFFFFFF, np.uint32)
    vhi = np.zeros(n, np.uint32)
    parts = _port(gid, vlo, vhi, H, L, shift, C, S=S)
    row = parts[0, 999 >> shift].view(L, C + 1)[999 & (L - 1)]
    assert row.tolist() == [255.0 * n] * C + [float(n)]
    assert float(parts.sum()) == 255.0 * n * C + n


def test_wrapper_checks():
    g = torch.zeros(8192, dtype=torch.int32)
    with pytest.raises(ValueError, match="S = 12"):
        GCK.group_chunk_partials(g, g, g, 128, 8, 3, 4, S=12)
    with pytest.raises(ValueError, match="exceeds"):
        GCK.group_chunk_partials(g, g, g, 256, 32, 5, 8)
    with pytest.raises(TypeError, match="int32"):
        GCK.group_chunk_partials(g.long(), g, g, 128, 8, 3, 4)
    with pytest.raises(ValueError, match="out_dtype"):
        GCK.group_chunk_partials(g, g, g, 128, 8, 3, 4,
                                 out_dtype=torch.float64)
    out = torch.empty((1, 128, 40), dtype=torch.float32)
    assert GCK.group_chunk_partials(g, g, g, 128, 8, 3, 4, out=out) is out
    assert float(out.sum()) == 8192.0       # 8192 rows of group 0, value 0


# ------------------------------------------------- the chunk route -------

def _route_case(rng, G, P, N, vbits):
    gids = rng.integers(-2, G + 3, (P, N)).astype(np.int32)
    vals = rng.integers(0, 1 << vbits, (P, N), dtype=np.uint64)
    maskb = rng.random((P, N)) < 0.7
    words = np.stack([TBS.np_pack_mask(maskb[p]) for p in range(P)])
    return gids, vals, maskb, words


@pytest.mark.parametrize("G,P,N,C,bias", [
    (1000, 3, 8192, 6, 0), (1000, 2, 8192, 4, 12345), (200, 1, 4096, 8, 0),
    (8192, 1, 8192, 6, 77), (6000, 1, 8192, 5, 0), (20000, 2, 8192, 6, 0),
    (65536, 2, 16384, 6, 1 << 20)])
def test_group_count_chunks(G, P, N, C, bias):
    """Against the reference's _group_pallas (its kernel in interpret mode)
    chunk for chunk, against group_count_sum (the same python-int sums) and
    against numpy; 1 launch up to 8192 groups, ceil(G / 8192) past them."""
    rng = np.random.default_rng(G + C)
    gids, vals, maskb, words = _route_case(rng, G, P, N, 8 * C)
    vals = vals + np.uint64(bias)
    lo, hi = WD.split_u64(vals)
    t = dict(gids=torch.from_numpy(gids), mask=WD.to_words(words, "cpu"),
             pair=(WD.to_words(lo, "cpu"), WD.to_words(hi, "cpu")))
    before = GCK.PLAIN_CALLS["group_chunk_partials"]
    counts, chunks = TGB.group_count_chunks(t["gids"], t["mask"], t["pair"],
                                            G, C, bias)
    assert GCK.PLAIN_CALLS["group_chunk_partials"] - before \
        == max(1, -(-G // 8192))
    assert counts.dtype == torch.int64 and len(chunks) == C
    rc, rch, _mn, _mx = RGB._group_pallas(
        jnp.asarray(gids), jnp.asarray(words), jnp.asarray(vals), G,
        n_chunks=C, bias=jnp.uint64(bias) if bias else None)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rc))
    for a, b in zip(chunks, rch):
        np.testing.assert_array_equal(a.numpy().astype(np.uint64),
                                      np.asarray(b))
    sums = TGB.mxu_chunk_sums([c.numpy() for c in chunks]) \
        + bias * counts.numpy().astype(object)
    c2, s_lo, s_hi = TGB.group_count_sum(t["gids"], t["mask"], t["pair"], G)
    np.testing.assert_array_equal(counts.numpy(), c2.numpy())
    assert list(sums) == list(TGB.halves_sum(s_lo, s_hi))
    ok = maskb & (gids >= 0) & (gids < G)
    want = np.zeros(G, object)
    np.add.at(want, gids[ok], vals[ok].astype(object))
    assert list(sums) == list(want)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(gids[ok], minlength=G))


def test_chunk_geometry_equals_reference():
    for G in (1, 100, 128, 129, 1000, 1024, 4096, 4097, 8192):
        assert TGB._chunk_geometry(G) == RGB._pallas_group_geometry(G)
