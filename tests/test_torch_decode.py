"""Device decodes: knoxdb_tpu_torch against the knoxdb_tpu reference.

The bit-transpose decodes of encode/schemes.py at widths 0-64 on random
plane words (with all-ones and sign-bit words), and the group decodes of
exec/device.py (value halves and keys) on BITPACK, CONST and DICT groups
of one built segment. Tolerance 0: every output word is equal."""

import jax.numpy as jnp
import numpy as np
import pytest

from knoxdb_tpu.encode import schemes as RS
from knoxdb_tpu.exec import device as RD
from knoxdb_tpu.pack.segment import build_segment as r_build
from knoxdb_tpu.schema.schema import Builder as RBuilder
from knoxdb_tpu.types import FieldType as RFT
from knoxdb_tpu_torch.encode import schemes as TS
from knoxdb_tpu_torch.encode.schemes import Scheme
from knoxdb_tpu_torch.exec import device as TD
from knoxdb_tpu_torch.ops import words as WD
from knoxdb_tpu_torch.pack.segment import segment_from_reference

WIDTHS = [0, 1, 8, 9, 16, 31, 32, 33, 48, 64]


def _planes(rng, width, P=3, n32=16):
    pl = rng.integers(0, 1 << 32, (max(width, 1), P, n32),
                      dtype=np.uint64).astype(np.uint32)
    pl[:, :, 0] = 0xFFFFFFFF
    pl[:, :, 1] = 0x80000000
    pl[:, 0, 2] = 0x7FFFFFFF
    if width == 0:
        pl[:] = 0
    return pl


@pytest.mark.parametrize("width", WIDTHS)
def test_decode_bitplanes_pair(width):
    pl = _planes(np.random.default_rng(width), width)
    rlo, rhi = RS.decode_bitplanes_pair(jnp.asarray(pl), width)
    tlo, thi = TS.decode_bitplanes_pair(WD.to_words(pl, "cpu"), width)
    np.testing.assert_array_equal(WD.from_words(tlo), np.asarray(rlo))
    np.testing.assert_array_equal(WD.from_words(thi), np.asarray(rhi))
    # the pair is the port's halves form of decode_bitplanes_u64
    r64 = np.asarray(RS.decode_bitplanes_u64(jnp.asarray(pl), width))
    np.testing.assert_array_equal(
        WD.join_u64(WD.from_words(tlo), WD.from_words(thi)), r64)


@pytest.mark.parametrize("width", [w for w in WIDTHS if w <= 32])
def test_decode_bitplanes_u32(width):
    pl = _planes(np.random.default_rng(100 + width), width)
    want = np.asarray(RS.decode_bitplanes_u32(jnp.asarray(pl), width))
    got = TS.decode_bitplanes_u32(WD.to_words(pl, "cpu"), width)
    np.testing.assert_array_equal(WD.from_words(got), want)


def test_decode_rejects_wide_widths():
    pl = WD.to_words(np.zeros((65, 1, 1), np.uint32), "cpu")
    with pytest.raises(ValueError):
        TS.decode_bitplanes_pair(pl, 65)
    with pytest.raises(ValueError):
        TS.decode_bitplanes_u32(pl[:33], 33)


@pytest.fixture(scope="module")
def segs():
    """One segment whose columns give BITPACK (several widths), CONST
    (beside BITPACK in one column) and DICT (integer and bytes) groups."""
    rng = np.random.default_rng(5)
    pack, P = 1024, 6
    n = pack * P
    p = np.arange(n) // pack
    sv = np.array(["ant", "bee", "cat", "dog", "emu", "fox"], object)
    data = {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "u": rng.integers(0, 1 << 64, n, dtype=np.uint64),
        "i": rng.integers(-1 << 40, 1 << 40, n, dtype=np.int64),
        "c": np.where(p < 2, -7, rng.integers(-1000, 1000, n)),
        "k": np.array([10, 20, 30, 40, 5_000_000_000],
                      np.uint64)[rng.integers(0, 5, n)],
        "s": sv[rng.integers(0, 6, n)],
    }
    data["u"][:5] = np.uint64(0xFFFFFFFFFFFFFFFF)
    b = RBuilder("t").pk("id")
    for name, ft in (("u", "UINT64"), ("i", "INT64"), ("c", "INT64"),
                     ("k", "UINT64"), ("s", "STRING")):
        b = b.add(name, RFT[ft])
    rseg = r_build(b.finish(), data, pack_size=pack)
    rdev = RD.DeviceSegment(rseg)
    tdev = TD.DeviceSegment(segment_from_reference(rseg), "cpu")
    return rdev, tdev


@pytest.mark.parametrize("fname", ["u", "i", "c", "k", "s"])
def test_group_decodes(segs, fname):
    rdev, tdev = segs
    rgroups = rdev.column(fname).groups
    tgroups = tdev.column(fname).groups
    assert [g.sig() for g in rgroups] == [g.sig() for g in tgroups]
    for rg, tg in zip(rgroups, tgroups):
        rlo, rhi = RD.group_decode_halves(rg.sig(), rg.arrays, rdev.W)
        tlo, thi = TD.group_decode_halves(tg, tdev.W)
        np.testing.assert_array_equal(WD.from_words(tlo), np.asarray(rlo))
        np.testing.assert_array_equal(WD.from_words(thi), np.asarray(rhi))
        rkeys = np.asarray(RD.group_decode_keys(rg.sig(), rg.arrays,
                                                rdev.W))
        tkeys = TD.group_decode_keys(tg, tdev.W).numpy()
        np.testing.assert_array_equal(WD.u64_from_ordered(tkeys), rkeys)
        # the int64 keys sort as the u64 keys do
        order = np.argsort(tkeys.reshape(-1), kind="stable")
        assert (np.diff(rkeys.reshape(-1)[order].astype(object)) >= 0).all()


def test_group_decode_schemes_covered(segs):
    _rdev, tdev = segs
    schemes = {g.scheme for f in ("u", "i", "c", "k", "s")
               for g in tdev.column(f).groups}
    assert {Scheme.BITPACK, Scheme.CONST, Scheme.DICT} <= schemes
    widths = {g.width for f in ("u", "i") for g in tdev.column(f).groups}
    assert 64 in widths and any(32 < w < 64 for w in widths)


def test_group_decode_unported_schemes_raise():
    """No scheme is left that raises: ALP packs decode too, to their
    pack-relative enc (the base is a python int on the host), halves, keys
    and limbs equal to the reference's."""
    rng = np.random.default_rng(6)
    pack, P = 1024, 3
    n = pack * P
    data = {"id": np.arange(1, n + 1, dtype=np.uint64),
            "p": np.round(rng.uniform(-50.0, 900.0, n), 3)}
    rseg = r_build(RBuilder("t").pk("id").add("p", RFT.FLOAT64).finish(),
                   data, pack_size=pack)
    rdev = RD.DeviceSegment(rseg)
    tdev = TD.DeviceSegment(segment_from_reference(rseg), "cpu")
    tgroups = tdev.column("p").groups
    assert {g.scheme for g in tgroups} == {Scheme.ALP}
    for rg, tg in zip(rdev.column("p").groups, tgroups):
        assert rg.sig() == tg.sig()
        assert tg.bases == rg.bases and tg.exps == rg.exps
        rlo, rhi = RD.group_decode_halves(rg.sig(), rg.arrays, rdev.W)
        tlo, thi = TD.group_decode_halves(tg, tdev.W)
        np.testing.assert_array_equal(WD.from_words(tlo), np.asarray(rlo))
        np.testing.assert_array_equal(WD.from_words(thi), np.asarray(rhi))
        np.testing.assert_array_equal(
            WD.u64_from_ordered(TD.group_decode_keys(tg, tdev.W).numpy()),
            np.asarray(RD.group_decode_keys(rg.sig(), rg.arrays, rdev.W)))
        np.testing.assert_array_equal(
            WD.from_words(TD.group_decode_limbs(tg, tdev.W)),
            np.asarray(RD.group_decode_limbs(rg.sig(), rg.arrays, rdev.W)))
        # enc = relative + base decodes to the stored doubles
        enc = WD.join_u64(WD.from_words(tlo), WD.from_words(thi)) \
            .astype(np.int64)
        for j, pi in enumerate(tg.idx):
            vals = (enc[j] + tg.bases[j]) / 10.0 ** tg.exps[j]
            np.testing.assert_array_equal(
                vals, data["p"][pi * pack:(pi + 1) * pack])
