"""Segment (de)serialization: pack/segment.Segment <-> bytes (carried over from
knoxdb_tpu/store/segio.py).

Replaces the reference's block-encode-into-bolt-buckets path
(internal/block/encode.go:17-45 + pack table writer):
a sealed segment serializes as one blob per table epoch — a JSON manifest
plus raw little-endian array payloads (pickle-free; wide python ints
travel as fixed-width big-endian bytes). Blobs are immutable; the store
key is (table id, epoch, segment no).

OUTER COMPRESSION (reference block/compress.go:54-70 snappy/lz4/zstd):
every array payload is individually compressed when that shrinks it
(bit-packed planes are already dense; dict blobs / value arrays / stats
usually compress well) and the per-codec choice is recorded in the array
header — mirroring the reference's per-block compression byte. Codecs:
  zstd (default when the zstandard module is present — fastest decode,
  best ratio at level 1), lz4 (utils/native.py: the native C++ block
  codec, the same blocks as knoxdb_tpu's; literal-only blocks where the
  library does not build; any LZ4 block decodes), zlib (stdlib
  fallback/default otherwise), lzma (stdlib,
  high-ratio cold archival). KNOX_SEG_COMPRESS selects
  (zstd|lz4|zlib|lzma|off); the LOAD path decodes every codec
  regardless of the knob, so blobs written under any setting
  interoperate. KXSEG001 blobs (the first format) still load.
"""

from __future__ import annotations

import io
import json
import lzma
import os
import struct
import zlib

import numpy as np

try:                                    # not in every image; gated
    import zstandard as _zstd
except ImportError:                     # pragma: no cover
    _zstd = None

# name -> (compress(bytes)->bytes, decompress(bytes)->bytes)
_CODECS: dict = {
    "zlib": (lambda b: zlib.compress(b, 1), zlib.decompress),
    "lzma": (lambda b: lzma.compress(b, preset=0), lzma.decompress),
}
if _zstd is not None:
    _ZC = _zstd.ZstdCompressor(level=1)
    _ZD = _zstd.ZstdDecompressor()
    _CODECS["zstd"] = (_ZC.compress, _ZD.decompress)


def _lz4_c(b: bytes) -> bytes:
    # (reference compress.go:54-70 lz4 point on the speed/ratio
    # curve): LZ4 blocks through utils/native.py. The block format
    # carries no length, so frame = u64 LE raw length + block.
    from ..utils import native as NT
    return struct.pack("<Q", len(b)) + NT.lz4_compress(b)


def _lz4_d(b: bytes) -> bytes:
    from ..utils import native as NT
    (n,) = struct.unpack_from("<Q", b, 0)
    return NT.lz4_decompress(b[8:], n)


_CODECS["lz4"] = (_lz4_c, _lz4_d)

_DEFAULT_CODEC = "zstd" if _zstd is not None else "zlib"

from ..encode.schemes import EncodedPack, Scheme
from ..pack.segment import EncodedColumn, Segment
from ..pack.stats import FieldStats, SegmentStats
from ..schema.schema import Schema
from ..types import FilterType

__all__ = ["dump_segment", "load_segment"]

_MAGIC = b"KXSEG001"
_MAGIC2 = b"KXSEG002"      # adds per-array outer compression headers


def _arr_out(arrays: list, a: np.ndarray | None) -> int:
    if a is None:
        return -1
    arrays.append(np.ascontiguousarray(a))
    return len(arrays) - 1


def _ints_to_bytes(vals, nbytes: int) -> bytes:
    # keyform keys are non-negative and < 2^(8*nbytes)
    return b"".join(int(v).to_bytes(nbytes, "big") for v in vals)


def _bytes_to_ints(buf: bytes, nbytes: int) -> list[int]:
    return [int.from_bytes(buf[i * nbytes:(i + 1) * nbytes], "big")
            for i in range(len(buf) // nbytes)]


def dump_segment(seg: Segment) -> bytes:
    arrays: list[np.ndarray] = []
    man: dict = {
        "schema": seg.schema.to_dict(),
        "pack_size": seg.pack_size,
        "nrows_total": seg.nrows_total,
        "epoch": seg.epoch,
        "nrows": _arr_out(arrays, seg.nrows),
        "rid_base": _arr_out(arrays, seg.stats.rid_base),
        "columns": {},
        "stats": {},
    }
    for name, col in seg.columns.items():
        packs = []
        for p in col.packs:
            ent = {
                "scheme": int(p.scheme), "n": p.n, "nlimbs": p.nlimbs,
                "width": p.width, "min_key": str(p.min_key), "k": p.k,
                "card": p.card, "exp": p.exp,
                "planes": _arr_out(arrays, p.planes),
                "values": _arr_out(arrays, p.values),
                "ends": _arr_out(arrays, p.ends),
                "dict_keys": _arr_out(arrays, p.dict_keys),
            }
            if p.dict_bytes is not None:
                lens = np.array([len(b) for b in p.dict_bytes], np.uint32)
                blob = np.frombuffer(b"".join(p.dict_bytes), np.uint8)
                ent["db_lens"] = _arr_out(arrays, lens)
                ent["db_blob"] = _arr_out(arrays, blob.copy())
            packs.append(ent)
        man["columns"][name] = {
            "wide": col.wide,
            "bases": [str(b) for b in col.wide_bases] if col.wide_bases else None,
            "packs": packs,
        }
    for name, fs in seg.stats.fields.items():
        wide = fs.min_key.dtype == object
        nb = (seg.schema.field(name).type.bits // 8) or 8
        ent = {"filter_type": int(fs.filter_type), "wide": wide,
               "is_prefix": fs.is_prefix,
               "bloom": _arr_out(arrays, fs.bloom_words)}
        if fs.pack_filters is not None:
            if fs.filter_type.is_fuse:
                # per-pack xor-filter fingerprints (sizes vary): one
                # concatenated array + per-pack (seed, len) pairs
                ent["fuse_seeds"] = [int(f.seed) for f in fs.pack_filters]
                ent["fuse_lens"] = [len(f.fp) for f in fs.pack_filters]
                ent["fuse_fp"] = _arr_out(
                    arrays, np.concatenate([f.fp for f in fs.pack_filters]))
            elif fs.filter_type == FilterType.BITS:
                # exact sets as concatenated sorted u64 keys (zlib-outer
                # compressed like every payload); rebuilt on load
                vals = [f.to_array() for f in fs.pack_filters]
                ent["bits_lens"] = [len(v) for v in vals]
                ent["bits_keys"] = _arr_out(
                    arrays, np.concatenate(vals) if vals
                    else np.empty(0, np.uint64))
        if wide:
            ent["min_b"] = _ints_to_bytes(
                (int(v) for v in fs.min_key), nb).hex()
            ent["max_b"] = _ints_to_bytes(
                (int(v) for v in fs.max_key), nb).hex()
            ent["nb"] = nb
        else:
            ent["min"] = _arr_out(arrays, fs.min_key)
            ent["max"] = _arr_out(arrays, fs.max_key)
        man["stats"][name] = ent

    codec = os.environ.get("KNOX_SEG_COMPRESS", _DEFAULT_CODEC)
    if codec not in _CODECS and codec != "off":
        raise ValueError(f"unknown KNOX_SEG_COMPRESS codec {codec!r}; "
                         f"have {sorted(_CODECS)} or 'off'")
    compress = codec != "off"
    out = io.BytesIO()
    out.write(_MAGIC2 if compress else _MAGIC)
    mb = json.dumps(man).encode()
    out.write(struct.pack("<I", len(mb)))
    out.write(mb)
    out.write(struct.pack("<I", len(arrays)))
    for a in arrays:
        body = a.tobytes()
        h = {"dtype": a.dtype.str, "shape": a.shape}
        if compress:
            z = _CODECS[codec][0](body)
            if len(z) < len(body):          # per-array choice, recorded
                body = z
                h["comp"] = codec
        hdr = json.dumps(h).encode()
        out.write(struct.pack("<I", len(hdr)))
        out.write(hdr)
        out.write(struct.pack("<Q", len(body)))
        out.write(body)
    return out.getvalue()


def load_segment(buf: bytes) -> Segment:
    if buf[:8] not in (_MAGIC, _MAGIC2):
        raise ValueError("bad segment magic")
    off = 8
    (mlen,) = struct.unpack_from("<I", buf, off)
    off += 4
    man = json.loads(buf[off:off + mlen])
    off += mlen
    (na,) = struct.unpack_from("<I", buf, off)
    off += 4
    arrays: list[np.ndarray] = []
    for _ in range(na):
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        h = json.loads(buf[off:off + hlen])
        off += hlen
        (blen,) = struct.unpack_from("<Q", buf, off)
        off += 8
        body = buf[off:off + blen]
        comp = h.get("comp")
        if comp is not None:
            try:
                body = _CODECS[comp][1](body)
            except KeyError:
                raise ValueError(
                    f"segment array compressed with unavailable codec "
                    f"{comp!r} (have {sorted(_CODECS)})") from None
        a = np.frombuffer(body, dtype=np.dtype(h["dtype"]))
        arrays.append(a.reshape(h["shape"]).copy())
        off += blen

    def A(i):
        return None if i < 0 else arrays[i]

    schema = Schema.from_dict(man["schema"])
    columns: dict[str, EncodedColumn] = {}
    for name, cd in man["columns"].items():
        packs = []
        for pd in cd["packs"]:
            db = None
            if "db_lens" in pd:
                lens = A(pd["db_lens"])
                blob = A(pd["db_blob"]).tobytes()
                db, off = [], 0
                for ln in lens:
                    db.append(blob[off:off + int(ln)])
                    off += int(ln)
            packs.append(EncodedPack(
                Scheme(pd["scheme"]), pd["n"], pd["nlimbs"],
                width=pd["width"], min_key=int(pd["min_key"]),
                planes=A(pd["planes"]), values=A(pd["values"]),
                ends=A(pd["ends"]), k=pd["k"], card=pd["card"],
                exp=pd.get("exp", 0),
                dict_keys=A(pd["dict_keys"]), dict_bytes=db))
        bases = [int(b) for b in cd["bases"]] if cd["bases"] else None
        columns[name] = EncodedColumn(schema.field(name), packs,
                                      wide=cd["wide"], wide_bases=bases)

    fstats: dict[str, FieldStats] = {}
    for name, sd in man["stats"].items():
        if sd["wide"]:
            mins = np.array(_bytes_to_ints(bytes.fromhex(sd["min_b"]),
                                           sd["nb"]), object)
            maxs = np.array(_bytes_to_ints(bytes.fromhex(sd["max_b"]),
                                           sd["nb"]), object)
        else:
            mins, maxs = A(sd["min"]), A(sd["max"])
        pf = None
        if "fuse_fp" in sd:
            from ..filter.fuse import XorFilter
            fp = A(sd["fuse_fp"])
            pf, o = [], 0
            for seed, ln in zip(sd["fuse_seeds"], sd["fuse_lens"]):
                pf.append(XorFilter(seed, fp[o:o + ln].copy()))
                o += ln
        elif "bits_keys" in sd:
            from ..utils.ridset import RidSet
            keys = A(sd["bits_keys"])
            pf, o = [], 0
            for ln in sd["bits_lens"]:
                pf.append(RidSet.from_array(keys[o:o + ln]))
                o += ln
        fstats[name] = FieldStats(mins, maxs, A(sd["bloom"]),
                                  FilterType(sd["filter_type"]),
                                  is_prefix=sd.get("is_prefix", False),
                                  pack_filters=pf)

    stats = SegmentStats(A(man["nrows"]), A(man["rid_base"]), fstats)
    return Segment(schema, man["pack_size"], man["nrows_total"],
                   A(man["nrows"]), columns, stats, man["epoch"])
