"""Immutable column segments (carried over from knoxdb_tpu/pack/segment.py).

A segment is a horizontal slice of a table as a set of fixed-geometry
packs (pack_size rows, padded), each column encoded per pack with the
cheapest scheme (encode/select.py) and covered by zone-map + bloom stats
(pack/stats.py). All packs of a segment share shapes, so the device side
(exec/device.py) stacks them into scheme-grouped tensors.

`segment_from_reference` turns a knoxdb_tpu Segment into this package's
Segment by reading its attributes, without importing knoxdb_tpu, so that
tests can run both engines on the very same packs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..encode import select as sel
from ..encode import schemes as S
from ..encode.schemes import EncodedPack, Scheme
from ..schema.schema import Field, Schema
from ..types import FieldType, FilterType, IndexType
from ..utils import limbs as lb
from .stats import FieldStats, SegmentStats

__all__ = ["EncodedColumn", "Segment", "build_segment", "segment_from_reference"]


@dataclass
class EncodedColumn:
    field: Field
    packs: list[EncodedPack]
    wide: bool                      # keyform wider than 64 bits
    # wide columns: per-pack python-int bases (min key), None for narrow
    wide_bases: list[int] | None = None

    @property
    def nlimbs(self) -> int:
        return self.field.type.nlimbs

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.packs)


@dataclass
class Segment:
    schema: Schema
    pack_size: int
    nrows_total: int
    nrows: np.ndarray                      # i64[P] valid rows per pack
    columns: dict[str, EncodedColumn]
    stats: SegmentStats
    epoch: int = 0

    @property
    def npacks(self) -> int:
        return len(self.nrows)

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns.values())


def _split(n: int, pack_size: int) -> list[tuple[int, int]]:
    return [(i, min(i + pack_size, n)) for i in range(0, max(n, 1), pack_size)]


def _encode_narrow(field: Field, keys64: np.ndarray, bounds,
                   pack_size: int, raw=None
                   ) -> tuple[EncodedColumn, list[np.ndarray]]:
    packs, per_pack_keys = [], []
    L = field.type.nlimbs
    is_f64 = field.type == FieldType.FLOAT64
    for lo, hi in bounds:
        k = keys64[lo:hi]
        per_pack_keys.append(k)
        if is_f64 and raw is not None:
            # floats: try exact decimal-int transform first (ALP)
            p = S.encode_alp(np.asarray(raw[lo:hi], np.float64), pack_size,
                             width_round=sel.round_width)
            if p is not None:
                packs.append(p)
                continue
        packs.append(sel.encode_pack(k, L, pack_size))
    return EncodedColumn(field, packs, wide=False), per_pack_keys


def _encode_wide(field: Field, limbs: np.ndarray, bounds,
                 pack_size: int) -> tuple[EncodedColumn, list[np.ndarray]]:
    """128/256-bit columns. Per pack: if (max-min) fits 64 bits -> bitpack
    relative keys; elif low cardinality -> dict of limb rows; else raw."""
    L = limbs.shape[0]
    packs, bases, per_pack_keys = [], [], []
    for lo, hi in bounds:
        sub = limbs[:, lo:hi]
        ints = _limbs_to_ints(sub)
        per_pack_keys.append(ints)
        mn, mx = int(ints.min()), int(ints.max())
        rng = mx - mn
        if rng == 0:
            packs.append(S.encode_const(sub[:, :1], hi - lo))
            bases.append(mn)
        elif rng < (1 << 63):
            rel = np.array([int(v) - mn for v in ints], dtype=np.uint64)
            w = sel.round_width(rng.bit_length())
            packs.append(S.encode_bitpack(rel, L, 0, w, pack_size))
            bases.append(mn)
        else:
            packs.append(S.encode_raw(sub, hi - lo, pack_size))
            bases.append(0)
    return EncodedColumn(field, packs, wide=True, wide_bases=bases), per_pack_keys


def _encode_strings(field: Field, raw, bounds, pack_size: int):
    """STRING/BYTES columns: per-pack sorted byte dictionary + code planes
    (see encode/schemes.encode_string_dict). Zone maps hold 8-byte prefix
    keys (CONSERVATIVE: pruning uses strict compares only — equal prefixes
    cannot decide); optional bloom over full byte values."""
    from ..filter import bloom as BL
    if field.filter == FilterType.BITS:
        raise ValueError(
            f"field {field.name}: FilterType.BITS is not supported for "
            f"STRING/BYTES; use bloom/bfuse")
    if field.filter.is_fuse:
        raise NotImplementedError(
            f"field {field.name}: pack filter {field.filter.name} is not "
            f"ported yet (ROADMAP.md queue 1 item 12: filter/fuse.py)")
    vals = list(raw)
    packs = []
    pref_min = []
    pref_max = []
    blooms = [] if field.filter.is_bloom else None
    for lo, hi in bounds:
        p = S.encode_string_dict(vals[lo:hi], pack_size,
                                 width_round=sel.round_width)
        packs.append(p)
        pref_min.append(int(p.dict_keys[0]) if p.card else 0)
        pref_max.append(int(p.dict_keys[-1]) if p.card else 0)
        if blooms is not None:
            nbits = BL.bloom_bits(pack_size, field.filter)
            blooms.append(BL.build_bytes_np(p.dict_bytes, nbits))
    col = EncodedColumn(field, packs, wide=False)
    fs = FieldStats(np.array(pref_min, np.uint64),
                    np.array(pref_max, np.uint64),
                    np.stack(blooms) if blooms else None,
                    field.filter)
    fs.is_prefix = True
    return col, fs


def _limbs_to_ints(limbs: np.ndarray) -> np.ndarray:
    L, n = limbs.shape
    out = np.empty(n, object)
    for i in range(n):
        x = 0
        for l in range(L):
            x = (x << 32) | int(limbs[l, i])
        out[i] = x
    return out


def build_segment(schema: Schema, data: dict[str, np.ndarray],
                  pack_size: int, epoch: int = 0) -> Segment:
    """data: field name -> native-typed numpy array (or python-int list for
    wide types). All columns must share length. Rows are stored in input
    order (the table engine sorts by pk before building). The reference's
    shard-uniform option waits for the parallel slice (ROADMAP.md queue 1
    item 11)."""
    if pack_size < 32 or pack_size & (pack_size - 1):
        raise ValueError(f"pack_size must be a power of two >= 32, "
                         f"got {pack_size}")
    names = [f.name for f in schema.fields]
    n = len(data[names[0]])
    bounds = _split(n, pack_size)
    P = len(bounds)
    nrows = np.array([hi - lo for lo, hi in bounds], np.int64)

    columns: dict[str, EncodedColumn] = {}
    fstats: dict[str, FieldStats] = {}
    for f in schema.fields:
        raw = data[f.name]
        if f.type.is_bytes_like:
            columns[f.name], fstats[f.name] = _encode_strings(
                f, raw, bounds, pack_size)
            continue
        wide = f.type.nlimbs > 2
        if wide:
            limbs = lb.to_keyform(raw, f.type)
            col, keys = _encode_wide(f, limbs, bounds, pack_size)
        else:
            keys64 = lb.to_keys64(raw, f.type)
            col, keys = _encode_narrow(f, keys64, bounds, pack_size,
                                       raw=raw)
        columns[f.name] = col
        limbs_per_pack = None
        if f.filter != FilterType.NONE:
            limbs = lb.to_keyform(raw, f.type)
            limbs_per_pack = [limbs[:, lo:hi] for lo, hi in bounds]
        fstats[f.name] = FieldStats.from_packs(
            keys, wide, limbs_per_pack, f.filter, pack_size)

    rid_base = np.arange(P, dtype=np.uint64) * np.uint64(pack_size)
    stats = SegmentStats(nrows, rid_base, fstats)
    return Segment(schema, pack_size, n, nrows, columns, stats, epoch)


# --------------------------------------------------- reference segments ---

def segment_from_reference(seg) -> Segment:
    """A knoxdb_tpu Segment -> this package's Segment, field by field.

    The reference's Segment holds nothing but numpy arrays, python ints
    and enums, so its packs are read by attribute and the enums mapped by
    value; knoxdb_tpu is never imported."""
    fields = [Field(f.name, FieldType(int(f.type)), id=f.id, is_pk=f.is_pk,
                    index=IndexType(int(f.index)),
                    filter=FilterType(int(f.filter)), scale=f.scale,
                    fixed=f.fixed, is_meta=f.is_meta, is_enum=f.is_enum,
                    enum_name=f.enum_name)
              for f in seg.schema.fields]
    schema = Schema(seg.schema.name, fields, seg.schema.version)
    columns = {}
    for name, col in seg.columns.items():
        packs = [EncodedPack(Scheme(int(p.scheme)), p.n, p.nlimbs,
                             width=p.width, min_key=p.min_key,
                             planes=p.planes, values=p.values, ends=p.ends,
                             k=p.k, card=p.card, exp=p.exp,
                             dict_keys=p.dict_keys, dict_bytes=p.dict_bytes)
                 for p in col.packs]
        columns[name] = EncodedColumn(schema.field(name), packs, col.wide,
                                      col.wide_bases)
    fstats = {}
    for name, fs in seg.stats.fields.items():
        if fs.pack_filters is not None:
            raise NotImplementedError(
                f"field {name}: pack filter {fs.filter_type.name} is not "
                f"ported yet (ROADMAP.md queue 1 item 12: filter/fuse.py, "
                f"utils/ridset.py)")
        st = FieldStats(fs.min_key, fs.max_key, fs.bloom_words,
                        FilterType(int(fs.filter_type)))
        st.is_prefix = fs.is_prefix
        fstats[name] = st
    stats = SegmentStats(seg.stats.nrows, seg.stats.rid_base, fstats)
    return Segment(schema, seg.pack_size, seg.nrows_total, seg.nrows,
                   columns, stats, seg.epoch)
