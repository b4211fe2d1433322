"""knoxdb_tpu_torch's WAL, wire codec, KV stores and segment blobs against
knoxdb_tpu: the same writes give the same bytes on disk, and each package
reads what the other wrote (mirrors tests/test_wal_store.py and
tests/test_wire_fuzz.py)."""

import numpy as np
import pytest

import knoxdb_tpu.pack.segment as RSEG
import knoxdb_tpu.schema.schema as RSCH
import knoxdb_tpu.schema.wire as RWIRE
import knoxdb_tpu.store.kv as RKV
import knoxdb_tpu.store.segio as RSEGIO
import knoxdb_tpu.types as RT
import knoxdb_tpu.utils.native as RNT
import knoxdb_tpu.wal.wal as RWAL
import knoxdb_tpu_torch.pack.segment as TSEG
import knoxdb_tpu_torch.schema.schema as TSCH
import knoxdb_tpu_torch.schema.wire as TWIRE
import knoxdb_tpu_torch.store.kv as TKV
import knoxdb_tpu_torch.store.segio as TSEGIO
import knoxdb_tpu_torch.types as TT
import knoxdb_tpu_torch.utils.native as TNT
import knoxdb_tpu_torch.wal.wal as TWAL


def _records(W, n=20, size=50):
    return [W.Record(W.RecordType.INSERT if i % 3 else W.RecordType.DELETE,
                     entity=1 + i % 2, txid=i, data=bytes([i]) * (size + i))
            for i in range(n)]


def _seg_bytes(path):
    return {p.name: p.read_bytes() for p in sorted(path.glob("*.seg"))}


def _rec_tuple(r):
    return (int(r.type), r.entity, r.txid, r.lsn, bytes(r.data))


@pytest.mark.parametrize("max_segment", [256, 1 << 20])
def test_wal_bytes_equal_and_cross_read(tmp_path, max_segment):
    lsns = {}
    for name, W in (("ref", RWAL), ("port", TWAL)):
        w = W.Wal(tmp_path / name, max_segment=max_segment)
        lsns[name] = [w.write(r) for r in _records(W)]
        w.write(W.Record(W.RecordType.COMMIT, entity=2, txid=99))
        w.sync()
        w.close()
    assert lsns["ref"] == lsns["port"]
    ref, port = _seg_bytes(tmp_path / "ref"), _seg_bytes(tmp_path / "port")
    assert ref and ref == port
    # each package reads the other's log, with seeks and entity filters
    for W, other in ((TWAL, "ref"), (RWAL, "port")):
        w = W.Wal(tmp_path / other)
        recs = [_rec_tuple(r) for r in w.records()]
        assert [r[2] for r in recs] == list(range(20)) + [99]
        assert [r.txid for r in w.records(from_lsn=lsns["ref"][10])] \
            == list(range(10, 20)) + [99]
        assert [r.txid for r in w.records(entity=2)] \
            == [i for i in range(20) if i % 2] + [99]
        w.close()
    for W in (RWAL, TWAL):
        a = W.Wal(tmp_path / "ref")
        b = W.Wal(tmp_path / "port")
        assert [_rec_tuple(r) for r in a.records()] \
            == [_rec_tuple(r) for r in b.records()]
        a.close()
        b.close()


def test_wal_gc_same_segments(tmp_path):
    out = {}
    for name, W in (("ref", RWAL), ("port", TWAL)):
        w = W.Wal(tmp_path / name, max_segment=128)
        last = 0
        for i in range(50):
            last = w.write(W.Record(W.RecordType.INSERT, entity=1, txid=i,
                                    data=b"x" * 40))
        w.sync()
        removed = w.gc(last)
        out[name] = (removed, [r.txid for r in w.records()],
                     sorted(p.name for p in (tmp_path / name).glob("*.seg")))
        w.close()
    assert out["ref"][0] > 0
    assert out["ref"] == out["port"]


@pytest.mark.parametrize("damage", ["tail", "body"])
def test_wal_recovery_modes_equal(tmp_path, damage):
    """A torn tail (TRUNCATE) and a flipped body byte (SKIP, IGNORE,
    FAIL) recover to the same records in both packages."""
    got = {}
    for name, W in (("ref", RWAL), ("port", TWAL)):
        d = tmp_path / name
        w = W.Wal(d, max_segment=1 << 20)
        lsns = [w.write(W.Record(W.RecordType.INSERT, entity=1, txid=i,
                                 data=b"payload-%d" % i)) for i in range(5)]
        w.sync()
        w.close()
        seg = next(d.glob("*.seg"))
        if damage == "tail":
            with open(seg, "ab") as fh:
                fh.write(b"\x01garbage-partial-record")
        else:
            with open(seg, "r+b") as fh:
                fh.seek(lsns[2] + 22)
                b = fh.read(1)
                fh.seek(lsns[2] + 22)
                fh.write(bytes([b[0] ^ 0xFF]))
        w2 = W.Wal(d)
        with pytest.raises(Exception):
            list(w2.records(mode=W.RecoveryMode.FAIL))
        res = {}
        for mode in ("SKIP", "IGNORE", "TRUNCATE"):
            res[mode] = [_rec_tuple(r) for r in
                         w2.records(mode=getattr(W.RecoveryMode, mode))]
        res["after"] = [_rec_tuple(r) for r in
                        w2.records(mode=W.RecoveryMode.SKIP)]
        got[name] = (res, seg.read_bytes())
        w2.close()
    assert got["ref"] == got["port"]


def test_wal_delayed_sync(tmp_path):
    w = TWAL.Wal(tmp_path / "wal", sync="delay", flush_interval=0.005)
    futs = [w.write_delayed(TWAL.Record(TWAL.RecordType.INSERT, entity=1,
                                        txid=i, data=b"d" * 20))
            for i in range(10)]
    for f in futs:
        assert f.wait(timeout=2.0), "delayed fsync did not land"
    assert w.synced_lsn >= futs[-1]._lsn
    assert len(list(w.records())) == 10
    w.close()


# ----------------------------------------------------------- wire codec --

def _wire_schema(S, T, fts, name):
    b = S.Builder(name).pk("id")
    for i, ft in enumerate(fts):
        b.add(f"c{i}", getattr(T.FieldType, ft))
    return b.finish()


_POOL = ["UINT64", "INT64", "INT32", "UINT16", "INT8", "FLOAT64", "FLOAT32",
         "BOOLEAN", "TIMESTAMP", "INT128", "INT256", "DECIMAL128", "STRING",
         "BYTES"]


def _rand_col(rng, ft, n):
    if ft in ("STRING", "BYTES"):
        vals = [bytes(rng.integers(0, 256, int(rng.integers(0, 20)),
                                   dtype=np.uint8)) for _ in range(n)]
        return [v.hex() for v in vals] if ft == "STRING" else vals
    if ft in ("INT128", "INT256", "DECIMAL128"):
        bits = getattr(TT.FieldType, ft).bits
        return [int(x) << int(rng.integers(0, bits - 40))
                for x in rng.integers(-1 << 30, 1 << 30, n)]
    if ft == "BOOLEAN":
        return rng.integers(0, 2, n).astype(bool)
    if ft in ("FLOAT64", "FLOAT32"):
        a = rng.normal(0, 1e6, n)
        a[:3] = [0.0, -0.0, np.inf][:min(3, n)] if n >= 3 else a[:3]
        return a.astype(np.float64 if ft == "FLOAT64" else np.float32)
    ftt = getattr(TT.FieldType, ft)
    info_bits = min(ftt.bits, 63) - 1
    lo = -(1 << info_bits) if ftt.is_signed else 0
    from knoxdb_tpu_torch.utils import limbs as lb
    return rng.integers(lo, 1 << info_bits, n, dtype=lb.numpy_dtype(ftt))


def _cols_equal(a, b):
    assert len(a) == len(b)
    if len(a) and isinstance(a, np.ndarray) and a.dtype != object:
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    else:
        assert [bytes(x) if isinstance(x, memoryview) else x for x in a] \
            == [bytes(x) if isinstance(x, memoryview) else x for x in b]


@pytest.mark.parametrize("seed", range(8))
def test_wire_bytes_equal_fuzz(seed):
    rng = np.random.default_rng(seed)
    fts = [_POOL[int(i)] for i in rng.integers(0, len(_POOL),
                                                int(rng.integers(1, 7)))]
    n = int(rng.integers(0, 300))
    data = {"id": np.arange(1, n + 1, dtype=np.uint64)}
    for i, ft in enumerate(fts):
        data[f"c{i}"] = _rand_col(rng, ft, n)
    rs = _wire_schema(RSCH, RT, fts, f"fz{seed}")
    ts = _wire_schema(TSCH, TT, fts, f"fz{seed}")
    rbuf = RWIRE.encode_batch(rs, data, n)
    tbuf = TWIRE.encode_batch(ts, data, n)
    assert rbuf == tbuf
    rout, rn = RWIRE.decode_batch(rs, rbuf)
    tout, tn = TWIRE.decode_batch(ts, rbuf)
    assert rn == tn == n
    for name in rout:
        _cols_equal(rout[name], tout[name])
    # zero-copy views agree with the copying decode, point access too
    rv, tv = RWIRE.BatchView(rs, rbuf), TWIRE.BatchView(ts, rbuf)
    assert rv.nrows == tv.nrows == n
    for name in rout:
        _cols_equal(rv.column(name), tv.column(name))
    for i in range(min(n, 3)):
        assert rv.row(i).keys() == tv.row(i).keys()
        for k, v in rv.row(i).items():
            w = tv.row(i)[k]
            if isinstance(v, float) and np.isnan(v):
                assert np.isnan(w)
            else:
                assert (bytes(v) if isinstance(v, memoryview) else v) \
                    == (bytes(w) if isinstance(w, memoryview) else w)


def test_wire_rejects_garbage():
    sch = TSCH.Builder("g").pk("id").add("v", TT.FieldType.INT64).finish()
    with pytest.raises(Exception):
        TWIRE.decode_batch(sch, b"\x00" * 32)
    buf = TWIRE.encode_batch(sch, {"id": np.arange(1, 4, dtype=np.uint64),
                                   "v": np.arange(3)}, 3)
    with pytest.raises(Exception):
        TWIRE.decode_batch(sch, buf[:-3])


def test_kv_stores_same_files(tmp_path):
    got = {}
    for name, KV in (("ref", RKV), ("port", TKV)):
        out = []
        for store in (KV.MemStore(), KV.FileStore(tmp_path / name)):
            b = store.bucket("t1")
            b.put(b"k1", b"v1")
            b.put(b"k2", b"v2" * 100)
            out.append((b.get(b"k1"), list(b.keys())))
            b.delete(b"k1")
            out.append((b.get(b"k1"), list(b.keys())))
            with pytest.raises(KeyError):
                store.bucket("nope", create=False)
        got[name] = (out, sorted((str(p.relative_to(tmp_path / name)),
                                  p.read_bytes())
                                 for p in (tmp_path / name).rglob("*")
                                 if p.is_file()))
        store.drop_bucket("t1")
    assert got["ref"] == got["port"]


# ------------------------------------------------------- segment blobs --

def _seg_schema(S, T):
    FT, FL = T.FieldType, T.FilterType
    return (S.Builder("s").pk("id")
            .add("v", FT.UINT64, filter=FL.BLOOM_2B)
            .add("f8", FT.UINT32, filter=FL.BFUSE8)
            .add("f16", FT.INT64, filter=FL.BFUSE16)
            .add("bits", FT.UINT16, filter=FL.BITS)
            .add("w", FT.INT128)
            .add("s", FT.STRING, filter=FL.BFUSE8)
            .add("x", FT.FLOAT64)
            .finish())


def _seg_data(rng, n=1000):
    return {
        "id": np.arange(1, n + 1, dtype=np.uint64),
        "v": rng.integers(0, 50, n, dtype=np.uint64),
        "f8": rng.integers(0, 1 << 20, n).astype(np.uint32),
        "f16": rng.integers(-1 << 40, 1 << 40, n),
        "bits": rng.integers(0, 300, n).astype(np.uint16),
        "w": [int(x) * 10**25 for x in rng.integers(-50, 50, n)],
        "s": [f"name{int(x)}" for x in rng.integers(0, 40, n)],
        "x": np.round(rng.normal(0, 100, n), 2),
    }


@pytest.mark.parametrize("codec", ["zlib", "lzma", "off"])
def test_segment_blob_bytes_equal(rng, monkeypatch, codec):
    monkeypatch.setenv("KNOX_SEG_COMPRESS", codec)
    data = _seg_data(rng)
    rseg = RSEG.build_segment(_seg_schema(RSCH, RT), data, pack_size=256)
    tseg = TSEG.build_segment(_seg_schema(TSCH, TT), data, pack_size=256)
    rblob = RSEGIO.dump_segment(rseg)
    tblob = TSEGIO.dump_segment(tseg)
    assert rblob == tblob
    # the port loads the reference's blob into a segment that dumps to
    # the same bytes again, filters included
    back = TSEGIO.load_segment(rblob)
    assert TSEGIO.dump_segment(back) == rblob
    for name in ("f8", "f16", "s", "bits"):
        assert back.stats.fields[name].pack_filters is not None


def test_segment_lz4_blobs_decode_under_both(rng, monkeypatch):
    """Each package loads both packages' lz4 blobs into the same
    segment (native blocks, or the port's literal-only fallback blocks
    where its library does not build)."""
    monkeypatch.setenv("KNOX_SEG_COMPRESS", "lz4")
    data = _seg_data(rng, 600)
    rseg = RSEG.build_segment(_seg_schema(RSCH, RT), data, pack_size=256)
    tseg = TSEG.build_segment(_seg_schema(TSCH, TT), data, pack_size=256)
    rblob = RSEGIO.dump_segment(rseg)
    tblob = TSEGIO.dump_segment(tseg)
    monkeypatch.setenv("KNOX_SEG_COMPRESS", "off")
    want = RSEGIO.dump_segment(rseg)
    for blob in (rblob, tblob):
        assert TSEGIO.dump_segment(TSEGIO.load_segment(blob)) == want
        assert RSEGIO.dump_segment(RSEGIO.load_segment(blob)) == want


def test_segment_unknown_codec_raises(rng, monkeypatch):
    tseg = TSEG.build_segment(_seg_schema(TSCH, TT), _seg_data(rng, 300),
                              pack_size=256)
    monkeypatch.setenv("KNOX_SEG_COMPRESS", "lz9")
    with pytest.raises(ValueError, match="unknown KNOX_SEG_COMPRESS"):
        TSEGIO.dump_segment(tseg)


def test_lz4_codec_cross_decode(rng):
    cases = [b"", b"a", b"abcd" * 4,
             bytes(rng.integers(0, 256, 100_000, dtype=np.uint8)),
             bytes(np.zeros(65_536, np.uint8)),
             b"the quick brown fox " * 500]
    for data in cases:
        t = TNT.lz4_compress(data)
        r = RNT.lz4_compress(data)
        if TNT.available() and RNT.available():
            assert t == r                  # one native codec, one block
        for block in (t, r, TNT.lz4_compress_np(data)):
            assert TNT.lz4_decompress(block, len(data)) == data
            assert RNT.lz4_decompress(block, len(data)) == data
            assert TNT.lz4_decompress_np(block, len(data)) == data
    with pytest.raises(ValueError):
        TNT.lz4_decompress(b"\xf0\xff\xff", 10)
