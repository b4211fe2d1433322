"""Device-resident segment store + per-group matchers and aggregates.

The port of knoxdb_tpu/exec/device.py. A DeviceSegment is the device image
of a pack/segment.Segment on an explicit torch device: every column's
packs are grouped by (scheme, width, k) and stacked, so one op serves a
whole group. Words are int32-carried u32 (ops/words.py); planes are
plane-major int32[max(w,1), Pg, W].

Matchers return packed words int32[Pg, W]. Aggregates return per-pack
exact partials that the host combines with python ints: masked per-plane
popcounts {"pcnt", "cnt"} and tournament winners {"mnmx", "cnt"}, the
same forms the fused scan kernels emit (ops/scan_kernels.py).

This slice matches narrow BITPACK, CONST and DICT code ranges and
aggregates narrow BITPACK; the other schemes raise NotImplementedError
naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..encode.schemes import Scheme
from ..ops import bitslice as B
from ..ops import words as WD
from ..pack.segment import EncodedColumn, Segment
from ..types import FieldType, FilterMode

__all__ = ["DeviceGroup", "DeviceColumn", "DeviceSegment", "group_match",
           "group_masked_sum", "group_masked_minmax"]

_TODO_SCHEMES = ("ROADMAP.md queue 1 item 3: DELTA/RLE/RAW/ALP and wide "
                 "matching and aggregates")


@dataclass
class DeviceGroup:
    scheme: Scheme
    width: int                 # bitplane width (BITPACK/DELTA/DICT/ALP)
    k: int                     # padded value count (RLE/DICT)
    nlimbs: int
    wide: bool
    idx: np.ndarray            # i64[Pg] pack indices into the segment
    idx_t: torch.Tensor | None = None            # idx on the device
    arrays: dict = field(default_factory=dict)   # name -> device tensor
    # host-side per-pack metadata aligned with idx:
    min_keys: np.ndarray | None = None   # u64[Pg] narrow BITPACK/DELTA bases
    bases: list[int] | None = None       # wide bitpack / ALP bases
    exps: list[int] | None = None        # ALP decimal exponents per pack
    dict_keys: list[np.ndarray] | None = None  # per-pack sorted u64 keys
    dict_bytes: list[list] | None = None  # per-pack sorted byte dicts

    @property
    def npacks(self) -> int:
        return len(self.idx)

    def sig(self) -> tuple:
        return (int(self.scheme), self.width, self.k, self.nlimbs,
                self.wide, self.npacks)


@dataclass
class DeviceColumn:
    field_type: FieldType
    wide: bool
    groups: list[DeviceGroup]

    def sig(self) -> tuple:
        return (int(self.field_type), tuple(g.sig() for g in self.groups))


class DeviceSegment:
    """Uploaded image of one Segment on `device` (columns upload on first
    use)."""

    def __init__(self, seg: Segment, device):
        self.seg = seg
        self.device = torch.device(device)
        self.P = seg.npacks
        self.N = seg.pack_size
        self.W = seg.pack_size // 32
        self.columns: dict[str, DeviceColumn] = {}
        # validity: mask the padding rows of the last pack
        valid = np.zeros((self.P, self.W), np.uint32)
        for p in range(self.P):
            full, rem = divmod(int(seg.nrows[p]), 32)
            valid[p, :full] = 0xFFFFFFFF
            if rem:
                valid[p, full] = (1 << rem) - 1
        self.valid_words = WD.to_words(valid, self.device)

    def column(self, name: str) -> DeviceColumn:
        col = self.columns.get(name)
        if col is None:
            col = _upload_column(self.seg.columns[name], self.device)
            self.columns[name] = col
        return col

    def arrays(self, names: list[str]) -> dict:
        """field -> per-group dicts of device tensors."""
        return {n: [g.arrays for g in self.column(n).groups] for n in names}

    def sig(self, names: list[str]) -> tuple:
        return (self.P, self.N,
                tuple((n, self.column(n).sig()) for n in names))


def _upload_column(col: EncodedColumn, device) -> DeviceColumn:
    bykey: dict[tuple, list[int]] = {}
    for i, p in enumerate(col.packs):
        bykey.setdefault((p.scheme, p.width, p.k), []).append(i)

    groups = []
    for (scheme, width, k), idxs in sorted(bykey.items()):
        packs = [col.packs[i] for i in idxs]
        idx = np.asarray(idxs, np.int64)
        g = DeviceGroup(scheme, width, k, col.nlimbs, col.wide, idx,
                        idx_t=torch.from_numpy(idx).to(device))
        if scheme in (Scheme.BITPACK, Scheme.DELTA, Scheme.DICT, Scheme.ALP):
            g.arrays["planes"] = WD.to_words(
                np.stack([p.planes for p in packs], axis=1), device)
        if scheme == Scheme.ALP:
            g.bases = [p.min_key for p in packs]
            g.exps = [p.exp for p in packs]
        if scheme in (Scheme.CONST, Scheme.RAW, Scheme.RLE, Scheme.DICT):
            kmax = max(p.values.shape[1] for p in packs)
            g.arrays["values"] = WD.to_words(
                np.stack([_pad_vals(p.values, kmax) for p in packs]), device)
        if scheme == Scheme.RLE:
            kmax = max(len(p.ends) for p in packs)
            g.arrays["ends"] = WD.to_words(
                np.stack([_pad_ends(p.ends, kmax) for p in packs]), device)
        if scheme in (Scheme.BITPACK, Scheme.DELTA):
            if col.wide:
                g.bases = [col.wide_bases[i] for i in idxs]
            else:
                g.min_keys = np.array([p.min_key for p in packs], np.uint64)
        if scheme == Scheme.DICT:
            g.dict_keys = [p.dict_keys for p in packs]
            if packs[0].dict_bytes is not None:
                g.dict_bytes = [p.dict_bytes for p in packs]
        if scheme == Scheme.CONST and col.wide:
            g.bases = [col.wide_bases[i] for i in idxs]
        groups.append(g)
    return DeviceColumn(col.field.type, col.wide, groups)


def _pad_vals(v: np.ndarray, k: int) -> np.ndarray:
    if v.shape[1] == k:
        return v
    out = np.empty((v.shape[0], k), v.dtype)
    out[:, :v.shape[1]] = v
    out[:, v.shape[1]:] = v[:, -1:]
    return out


def _pad_ends(e: np.ndarray, k: int) -> np.ndarray:
    out = np.full(k, 0xFFFFFFFF, np.uint32)
    out[:len(e)] = e
    return out


def _narrow_bitpack(g: DeviceGroup) -> bool:
    return g.scheme == Scheme.BITPACK and not g.wide


# --------------------------------------------------------------- matching ---

# DICT predicates are rewritten to code space on the host (exec/rewrite.py);
# code space is order-preserving, so the mode maps statically:
_DICT_CODE_MODE = {
    FilterMode.EQ: FilterMode.EQ, FilterMode.NE: FilterMode.NE,
    FilterMode.LT: FilterMode.LT, FilterMode.LE: FilterMode.LT,
    FilterMode.GT: FilterMode.GE, FilterMode.GE: FilterMode.GE,
    FilterMode.RANGE: FilterMode.RANGE,
    FilterMode.IN: FilterMode.IN, FilterMode.NOT_IN: FilterMode.IN,
}


def group_match(g: DeviceGroup, mode: FilterMode, consts: dict, W: int):
    """Evaluate one predicate leaf over one device group with the
    constants of exec/rewrite.leaf_group_consts. Returns int32[Pg, W]."""
    if g.scheme == Scheme.CONST:
        cm = consts["const_match"]
        return torch.zeros((g.npacks, W), dtype=torch.int32,
                           device=cm.device).masked_fill_(cm[:, None],
                                                          WD.FULL)
    if _narrow_bitpack(g) or g.scheme == Scheme.DICT:
        planes = g.arrays["planes"]
        kmode = _DICT_CODE_MODE[mode] if g.scheme == Scheme.DICT else mode
        if kmode == FilterMode.RANGE:
            return B.range_planes_rel(planes, consts["rel_lo"],
                                      consts["rel_hi"], g.width)
        if kmode in (FilterMode.IN, FilterMode.NOT_IN):
            m = B.in_planes_rel(planes, consts["rels"], g.width)
            return ~m if mode == FilterMode.NOT_IN else m
        return B.cmp_planes_rel(kmode, planes, consts["rel"], g.width)
    raise NotImplementedError(
        f"group_match: {g.scheme.name} (wide={g.wide}): {_TODO_SCHEMES}")


# ------------------------------------------------------------- aggregates ---

def group_masked_sum(g: DeviceGroup, mask_words):
    """Per-pack exact masked-sum partials of a narrow BITPACK group:
    {"pcnt": int64[Pg, max(w,1)], "cnt": int64[Pg]} (host adds
    min_key·count and the keyform bias)."""
    if not _narrow_bitpack(g):
        raise NotImplementedError(
            f"group_masked_sum: {g.scheme.name} (wide={g.wide}): "
            f"{_TODO_SCHEMES}")
    pcnt, cnt = B.masked_sum_planes(g.arrays["planes"], mask_words, g.width)
    return {"pcnt": pcnt, "cnt": cnt}


def group_masked_minmax(g: DeviceGroup, mask_words):
    """Per-pack masked (min, max) of a narrow BITPACK group as
    pack-relative u32 halves {"mnmx": int32[Pg, 4] (mn_lo, mn_hi, mx_lo,
    mx_hi), "cnt": int64[Pg]}; empty packs are gated on cnt by the host."""
    if not _narrow_bitpack(g):
        raise NotImplementedError(
            f"group_masked_minmax: {g.scheme.name} (wide={g.wide}): "
            f"{_TODO_SCHEMES}")
    planes = g.arrays["planes"]
    mn = B._tournament_planes(planes, mask_words, g.width, want_max=False)
    mx = B._tournament_planes(planes, mask_words, g.width, want_max=True)
    return {"mnmx": torch.stack([*mn, *mx], dim=1),
            "cnt": B.popcount_words(mask_words)}
