"""Columnar batch wire codec (carried over from
knoxdb_tpu/schema/wire.py).

The reference encodes row-wise wire buffers with an opcode-programmed
encoder and zero-copy views (pkg/schema/{encode,decode,
view}.go). This build is column-batch native — data crosses process /
WAL / store boundaries as schema-ordered column blocks:

    [u32 magic][u16 version][u32 nrows][per field: u8 kind, u64 len, bytes]

Fixed-width numerics serialize as little-endian native arrays; wide ints
(128/256) as fixed bits//8-byte big-endian values; strings/bytes as a
u32 length vector + concatenated blob. The codec is the WAL body format
(journal recovery replays these batches) and the store segment format's
row payload.
"""

from __future__ import annotations

import struct

import numpy as np

from .schema import Schema
from ..types import FieldType
from ..utils import limbs as lb

__all__ = ["encode_batch", "decode_batch", "BatchView"]

_MAGIC = 0x4B583_001 & 0xFFFFFFFF
_HDR = struct.Struct("<IHI")
_FLD = struct.Struct("<BQ")

_K_NATIVE = 1     # native little-endian numpy array
_K_WIDE = 2       # fixed-size big-endian signed-biased ints
_K_BYTES = 3      # u32 lengths + blob


def encode_batch(schema: Schema, data: dict, nrows: int) -> bytes:
    out = [_HDR.pack(_MAGIC, 1, nrows)]
    for f in schema.fields:
        col = data[f.name]
        ft = f.type
        if ft.is_bytes_like:
            items = [v.encode() if isinstance(v, str) else bytes(v)
                     for v in col]
            lens = np.array([len(b) for b in items], np.uint32)
            blob = b"".join(items)
            body = lens.tobytes() + blob
            out.append(_FLD.pack(_K_BYTES, len(body)))
            out.append(body)
        elif ft.bits > 64:
            nbytes = ft.bits // 8
            bias = 1 << (ft.bits - 1) if ft.is_signed else 0
            body = b"".join(
                int((int(v) + bias) % (1 << ft.bits)).to_bytes(nbytes, "big")
                for v in col)
            out.append(_FLD.pack(_K_WIDE, len(body)))
            out.append(body)
        else:
            arr = np.ascontiguousarray(np.asarray(col, lb.numpy_dtype(ft)))
            body = arr.tobytes()
            out.append(_FLD.pack(_K_NATIVE, len(body)))
            out.append(body)
    return b"".join(out)


def decode_batch(schema: Schema, buf: bytes) -> tuple[dict, int]:
    magic, ver, nrows = _HDR.unpack_from(buf, 0)
    if magic != _MAGIC:
        raise ValueError("bad wire magic")
    off = _HDR.size
    data: dict = {}
    for f in schema.fields:
        kind, blen = _FLD.unpack_from(buf, off)
        off += _FLD.size
        body = buf[off:off + blen]
        off += blen
        ft = f.type
        if kind == _K_BYTES:
            lens = np.frombuffer(body[:4 * nrows], np.uint32)
            blob = body[4 * nrows:]
            vals, p = [], 0
            for ln in lens:
                vals.append(blob[p:p + ln])
                p += ln
            if ft == FieldType.STRING:
                vals = [v.decode() for v in vals]
            data[f.name] = np.array(vals, object)
        elif kind == _K_WIDE:
            nbytes = ft.bits // 8
            bias = 1 << (ft.bits - 1) if ft.is_signed else 0
            vals = np.empty(nrows, object)
            for i in range(nrows):
                vals[i] = int.from_bytes(
                    body[i * nbytes:(i + 1) * nbytes], "big") - bias
            data[f.name] = vals
        else:
            data[f.name] = np.frombuffer(body, lb.numpy_dtype(ft)).copy()
    return data, nrows


class BatchView:
    """ZERO-COPY accessor over an encode_batch buffer — the columnar
    analog of the reference's opcode-programmed wire View
    (pkg/schema/view.go): the header parses ONCE into
    per-field (kind, offset, length) slots; every access after that
    reads straight out of the original buffer.

    - column(name): native fixed-width fields return a READ-ONLY numpy
      view INTO the buffer (no copy; .base is the buffer). Bytes fields
      return per-row memoryview slices (zero-copy; call bytes() to
      detach). Wide (128/256-bit) fields must materialize python ints
      (documented exception — there is no int128 dtype to view).
    - field(row, name): ONE value without touching the rest of the
      column (the View's point-access trick); strings decode lazily.
    """

    def __init__(self, schema: Schema, buf):
        self.schema = schema
        self.buf = buf
        magic, _ver, nrows = _HDR.unpack_from(buf, 0)
        if magic != _MAGIC:
            raise ValueError("bad wire magic")
        self.nrows = nrows
        self._slots: dict = {}
        off = _HDR.size
        for f in schema.fields:
            kind, blen = _FLD.unpack_from(buf, off)
            off += _FLD.size
            self._slots[f.name] = (kind, off, blen, f.type)
            off += blen
        self._str_offs: dict = {}      # lazy per-bytes-field offsets

    def _offsets(self, name: str):
        out = self._str_offs.get(name)
        if out is None:
            _k, off, _ln, _ft = self._slots[name]
            lens = np.frombuffer(self.buf, np.uint32, self.nrows, off)
            offs = np.zeros(self.nrows + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            out = self._str_offs[name] = offs
        return out

    def column(self, name: str):
        kind, off, blen, ft = self._slots[name]
        if kind == _K_NATIVE:
            return np.frombuffer(self.buf, lb.numpy_dtype(ft),
                                 self.nrows, off)
        if kind == _K_BYTES:
            offs = self._offsets(name)
            mv = memoryview(self.buf)
            base = off + 4 * self.nrows
            return [mv[base + int(offs[i]):base + int(offs[i + 1])]
                    for i in range(self.nrows)]
        nbytes = ft.bits // 8              # _K_WIDE: must materialize
        bias = 1 << (ft.bits - 1) if ft.is_signed else 0
        return np.array([
            int.from_bytes(self.buf[off + i * nbytes:
                                    off + (i + 1) * nbytes], "big") - bias
            for i in range(self.nrows)], object)

    def field(self, row: int, name: str):
        if not 0 <= row < self.nrows:
            raise IndexError(row)
        kind, off, _blen, ft = self._slots[name]
        if kind == _K_NATIVE:
            dt = lb.numpy_dtype(ft)
            v = np.frombuffer(self.buf, dt, 1,
                              off + row * np.dtype(dt).itemsize)[0]
            return v.item() if ft != FieldType.BOOLEAN else bool(v)
        if kind == _K_BYTES:
            offs = self._offsets(name)
            base = off + 4 * self.nrows
            raw = bytes(self.buf[base + int(offs[row]):
                                 base + int(offs[row + 1])])
            return raw.decode() if ft == FieldType.STRING else raw
        nbytes = ft.bits // 8
        bias = 1 << (ft.bits - 1) if ft.is_signed else 0
        return int.from_bytes(
            self.buf[off + row * nbytes:off + (row + 1) * nbytes],
            "big") - bias

    def row(self, i: int) -> dict:
        return {f.name: self.field(i, f.name)
                for f in self.schema.fields}
