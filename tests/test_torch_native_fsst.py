"""The port's native host library and FSST codec: every ctypes entry point
of knoxdb_tpu_torch.utils.native equals its numpy fallback bit for bit
(the cases of tests/test_native.py), the port's native LZ4 blocks and lz4
segment blobs equal knoxdb_tpu's byte for byte, the library is built
from native/knox_native.cc into knoxdb_tpu_torch/_build/, and FSST round
trips with knoxdb_tpu's symbol tables (tests/test_fsst.py). Only the
native half skips, and only where g++ is missing."""

import shutil
from pathlib import Path

import numpy as np
import pytest

import knoxdb_tpu.encode.fsst as RF
import knoxdb_tpu.pack.segment as RSEG
import knoxdb_tpu.schema.schema as RSCH
import knoxdb_tpu.store.segio as RSEGIO
import knoxdb_tpu.types as RT
import knoxdb_tpu.utils.native as RNT
import knoxdb_tpu_torch.encode.fsst as TF
import knoxdb_tpu_torch.pack.segment as TSEG
import knoxdb_tpu_torch.schema.schema as TSCH
import knoxdb_tpu_torch.store.segio as TSEGIO
import knoxdb_tpu_torch.types as TT
import knoxdb_tpu_torch.utils.native as NT
from knoxdb_tpu_torch.encode.schemes import _pack_bitplanes_np

native = pytest.mark.skipif(shutil.which("g++") is None,
                            reason="g++ not installed: no native library")

_ROOT = Path(__file__).resolve().parents[1]


@native
def test_library_builds_into_the_port():
    lib = NT.require()
    so = Path(NT.build_info["library"])
    assert NT.available() and lib is NT.lib
    assert so.parent == _ROOT / "knoxdb_tpu_torch" / "_build"
    assert so.exists() and so.name.startswith("libknox_native_")


@native
@pytest.mark.parametrize("n,width", [(1000, 7), (4096, 16), (33, 1),
                                     (64, 64), (100, 0), (70000, 48)])
def test_bitplane_pack_matches_numpy(rng, n, width):
    NT.require()
    n_pad = -(-n // 32) * 32
    vals = rng.integers(0, 1 << max(width, 1), n, dtype=np.uint64) \
        if width < 64 else \
        rng.integers(0, 1 << 63, n, dtype=np.uint64) * 2 + 1
    got = NT.bitplane_pack(vals, width, n_pad)
    want = _pack_bitplanes_np(vals, width, n_pad)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(NT.bitplane_unpack(got, width, n),
                                  NT.bitplane_unpack_np(want, width, n))
    if width:
        np.testing.assert_array_equal(NT.bitplane_unpack(got, width, n),
                                      vals)


@native
def test_analyze_matches_numpy(rng):
    NT.require()
    for keys in [rng.integers(0, 1000, 5000, dtype=np.uint64),
                 np.sort(rng.integers(0, 10**9, 1000, dtype=np.uint64)),
                 np.repeat(rng.integers(0, 5, 100, dtype=np.uint64), 37),
                 np.array([42], np.uint64), np.full(64, 7, np.uint64),
                 rng.integers(0, 1 << 64, 200_000, dtype=np.uint64),
                 np.array([0, (1 << 64) - 1, 0], np.uint64)]:
        assert NT.analyze_u64(keys) == NT.analyze_u64_np(keys)


@native
def test_bitset_indexes_matches_numpy(rng):
    NT.require()
    for n, p in ((3000, 0.2), (32, 1.0), (64, 0.0), (100_000, 0.01)):
        mask = rng.random(n) < p
        m = np.concatenate([mask, np.zeros((-n) % 32, bool)])
        words = np.packbits(m.reshape(-1, 32), axis=-1, bitorder="little") \
            .view(np.uint32).reshape(-1)
        got = NT.bitset_indexes(words, base=10)
        want = NT.bitset_indexes_np(words, base=10)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.flatnonzero(mask) + 10)


def _lz4_cases(rng):
    return [b"", b"a", b"abcd" * 4, b"the quick brown fox " * 500,
            bytes(rng.integers(0, 256, 100_000, dtype=np.uint8)),
            bytes(np.zeros(65_536, np.uint8)),
            bytes(rng.integers(0, 4, 50_000, dtype=np.uint8))]


@native
def test_lz4_native_equals_reference_and_fallback(rng):
    NT.require()
    assert RNT.available()
    for data in _lz4_cases(rng):
        block = NT.lz4_compress(data)
        assert block == RNT.lz4_compress(data)       # byte for byte
        assert NT.lz4_decompress(block, len(data)) == data
        assert NT.lz4_decompress_np(block, len(data)) == data
        lit = NT.lz4_compress_np(data)               # the fallback's block
        assert NT.lz4_decompress(lit, len(data)) == data
        assert RNT.lz4_decompress(lit, len(data)) == data
    for bad in (b"\xf0\xff\xff", b"\x1f\x41\x00\x00"):
        with pytest.raises(ValueError):
            NT.lz4_decompress(bad, 10)
        with pytest.raises(ValueError):
            NT.lz4_decompress_np(bad, 10)


def _seg(SCH, T, SEG, rng):
    sch = (SCH.Builder("s").pk("id").add("v", T.FieldType.INT64)
           .add("k", T.FieldType.UINT16).add("s", T.FieldType.STRING)
           .finish())
    r = np.random.default_rng(rng)
    n = 1500
    data = {"id": np.arange(1, n + 1, dtype=np.uint64),
            "v": r.integers(-10**6, 10**6, n),
            "k": r.integers(0, 9, n).astype(np.uint16),
            "s": [f"name{int(i)}" for i in r.integers(0, 40, n)]}
    return SEG.build_segment(sch, data, pack_size=256)


@native
def test_lz4_segment_blobs_equal_reference(monkeypatch):
    NT.require()
    monkeypatch.setenv("KNOX_SEG_COMPRESS", "lz4")
    rblob = RSEGIO.dump_segment(_seg(RSCH, RT, RSEG, 7))
    tblob = TSEGIO.dump_segment(_seg(TSCH, TT, TSEG, 7))
    assert tblob == rblob
    assert TSEGIO.dump_segment(TSEGIO.load_segment(rblob)) == rblob


def test_fallbacks_without_native(rng, monkeypatch):
    """The numpy half: the fallbacks the module takes without a library
    give the reference's fallback answers."""
    monkeypatch.setattr(NT, "lib", None)
    monkeypatch.setattr(NT, "_tried", True)
    assert not NT.available()
    with pytest.raises(RuntimeError, match="native library unavailable"):
        NT.require()
    vals = rng.integers(0, 1 << 20, 777, dtype=np.uint64)
    planes = NT.bitplane_pack(vals, 20, 800)
    np.testing.assert_array_equal(planes, _pack_bitplanes_np(vals, 20, 800))
    np.testing.assert_array_equal(NT.bitplane_unpack(planes, 20, 777), vals)
    assert NT.analyze_u64(vals) == NT.analyze_u64_np(vals)
    for data in _lz4_cases(rng):
        block = NT.lz4_compress(data)
        assert block == NT.lz4_compress_np(data)
        assert NT.lz4_decompress(block, len(data)) == data
        assert RNT.lz4_decompress(block, len(data)) == data


# ------------------------------------------------------------------ fsst --

def _corpus(rng):
    words = [b"http://example.com/page/", b"user_", b"transaction",
             b"abcdefgh", b"\xff\xfe escape bytes \xff"]
    return [words[int(i)] + str(int(x)).encode()
            for i, x in zip(rng.integers(0, len(words), 300),
                            rng.integers(0, 10**6, 300))]


def test_fsst_tables_and_roundtrip(rng):
    samples = _corpus(rng)
    st, rst = TF.train(samples), RF.train(samples)
    assert st.symbols == rst.symbols
    blob = st.dump()
    assert blob == rst.dump()
    st2, off = TF.SymbolTable.load(blob)
    assert off == len(blob) and st2.symbols == st.symbols
    total_in = total_out = 0
    for s in samples:
        c = TF.compress(st, s)
        assert c == RF.compress(rst, s)
        assert TF.decompress(st2, c) == s == RF.decompress(rst, c)
        total_in += len(s)
        total_out += len(c)
    assert total_out < total_in * 0.7, (total_out, total_in)


def test_fsst_edges():
    st, rst = TF.train([b"aaaa aaaa aaaa"]), RF.train([b"aaaa aaaa aaaa"])
    assert st.symbols == rst.symbols
    for s in (b"", b"\xff", b"\xff\xff\x00", b"zzz", bytes(range(256))):
        c = TF.compress(st, s)
        assert c == RF.compress(rst, s)
        assert TF.decompress(st, c) == s
