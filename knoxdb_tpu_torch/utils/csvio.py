"""CSV import/export with dialect sniffing (carried over from
knoxdb_tpu/utils/csvio.py; upstream pkg/csv).

Column batches <-> CSV with schema-driven type parsing: ints, floats,
decimals parsed exactly, wide ints, strings, bytes as hex.
"""

from __future__ import annotations

import csv as _csv
import io

import numpy as np

from ..schema.schema import Schema
from ..types import FieldType
from ..utils import limbs as lb

__all__ = ["sniff_dialect", "write_csv", "read_csv"]


def sniff_dialect(sample: str):
    try:
        return _csv.Sniffer().sniff(sample, delimiters=",;\t|")
    except _csv.Error:
        return _csv.excel


def _fmt(v, ft: FieldType, scale: int):
    if v is None:
        return ""
    if ft == FieldType.BYTES:
        return bytes(v).hex()
    if scale:
        return str(int(v) / 10**scale)
    if ft.is_float:
        return repr(float(v))
    if ft == FieldType.STRING:
        return str(v)
    return str(int(v)) if not isinstance(v, str) else v


def _parse(s: str, ft: FieldType, scale: int):
    if ft == FieldType.BYTES:
        return bytes.fromhex(s)
    if ft == FieldType.STRING:
        return s
    if scale:
        # exact decimal parse: shift the decimal point, no float round-trip
        neg = s.startswith("-")
        body = s.lstrip("+-")
        if "." in body:
            ip, fp = body.split(".", 1)
        else:
            ip, fp = body, ""
        fp = (fp + "0" * scale)[:scale]
        v = int(ip or "0") * 10**scale + int(fp or "0")
        return -v if neg else v
    if ft.is_float:
        return float(s)
    return int(s)


def write_csv(schema: Schema, data: dict, n: int, fh=None,
              delimiter: str = ",") -> str | None:
    out = fh or io.StringIO()
    w = _csv.writer(out, delimiter=delimiter)
    fields = [f for f in schema.fields if not f.is_meta]
    w.writerow([f.name for f in fields])
    for i in range(n):
        w.writerow([_fmt(data[f.name][i], f.type, f.scale) for f in fields])
    if fh is None:
        return out.getvalue()
    return None


def read_csv(schema: Schema, src, delimiter: str | None = None) -> dict:
    """CSV text/file -> column dict keyed by schema field names. Header
    row maps columns; unknown columns are ignored; missing ones error."""
    if isinstance(src, str):
        src = io.StringIO(src)
    sample = src.read(4096)
    src.seek(0)
    dialect = sniff_dialect(sample) if delimiter is None else None
    r = _csv.reader(src, dialect) if dialect else \
        _csv.reader(src, delimiter=delimiter)
    header = next(r)
    fields = [f for f in schema.fields if not f.is_meta]
    col_of = {}
    for f in fields:
        if f.name not in header:
            raise ValueError(f"csv: missing column {f.name}")
        col_of[f.name] = header.index(f.name)
    cols: dict[str, list] = {f.name: [] for f in fields}
    for row in r:
        if not row:
            continue
        for f in fields:
            cols[f.name].append(_parse(row[col_of[f.name]], f.type, f.scale))
    out: dict = {}
    for f in fields:
        vals = cols[f.name]
        if f.type.is_bytes_like or f.type.nlimbs > 2 or f.scale:
            out[f.name] = vals
        else:
            out[f.name] = np.asarray(vals, lb.numpy_dtype(f.type))
    return out
