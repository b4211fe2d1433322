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

Every scheme matches, aggregates and decodes: CONST, RAW, BITPACK
(narrow and wide), DELTA, RLE, DICT (integer and bytes dictionaries) and
ALP. On the card the range-family leaves over BITPACK planes (narrow and
wide), ALP planes and DICT code planes run the hand-written ladder kernel
and the BITPACK and ALP sums the popcount kernel
(ops/scan_kernels.range_mask_count, masked_plane_popcounts).

An ALP pack holds a FLOAT64 pack as decimal-scaled integers enc = round(v *
10^e) less the pack's smallest, bit-packed like a wide BITPACK pack whose
python-int base is that smallest enc: it matches on host-computed enc
bounds (exec/rewrite._alp_consts), sums and min/maxes in the enc domain
(the host divides by 10^e exactly), and decodes to its pack-relative enc.
Float columns in any other scheme hold order-preserving keyform bits
(utils/limbs.to_keyform): they match and min/max as integers, and sum as
floats in a fixed log-depth pairwise order (group_masked_sum_float).

Torch has no uint64. A decoded u64 key is a pair of int32-carried halves,
an int64 with the same bits where it is only added, subtracted or
prefix-summed (these wrap mod 2^64 as u64 does; ops/words.bits_i64), or
the order-preserving int64 (ops/words.ordered_i64) where it is compared.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..encode import schemes as S
from ..encode.schemes import Scheme
from ..ops import bitset as BS
from ..ops import bitslice as B
from ..ops import cmp as C
from ..ops import scan_kernels as SK
from ..ops import words as WD
from ..pack.segment import EncodedColumn, Segment
from ..types import FieldType, FilterMode

__all__ = ["DeviceGroup", "DeviceColumn", "DeviceSegment", "group_match",
           "group_masked_sum", "group_masked_minmax", "group_decode_halves",
           "group_decode_keys", "group_decode_limbs",
           "group_decode_limbs_abs", "add_base_limbs", "rle_row_runs",
           "rle_expand_mask", "rle_expand_values", "membership_bool",
           "membership_words", "group_masked_sum_float", "keyform_to_float",
           "pairwise_sum"]

_IN_SORT_MIN_K = 17    # below this the K-way EQ sweep is cheaper


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
                g.arrays["min_keys"] = torch.from_numpy(
                    WD.bits_from_u64(g.min_keys)).to(device)
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


# ------------------------------------------------------------ run expand ---

def _run_starts(ends: torch.Tensor):
    """ends int32-carried u32[Pg, k] (exclusive, padded with 0xFFFFFFFF) ->
    (starts, ends) as int64 values, starts[r] = ends[r - 1]."""
    e = WD.u32_to_i64(ends)
    return torch.cat([torch.zeros_like(e[:, :1]), e[:, :-1]], dim=1), e


def _scatter_add_rows(idx, vals, Pg: int, N: int):
    """Sum vals into a zero [Pg, N] buffer at the flat indices idx; an
    index of Pg * N is a spare slot that is cut off (the reference's
    scatter with mode="drop": index_add_ raises on an index outside)."""
    buf = torch.zeros(Pg * N + 1, dtype=vals.dtype, device=vals.device)
    buf.index_add_(0, idx.reshape(-1), vals.reshape(-1))
    return buf[:-1].view(Pg, N)


def rle_row_runs(ends: torch.Tensor, N: int) -> torch.Tensor:
    """u32[Pg, k] exclusive run ends -> int32[Pg, N] run index per row.

    One scatter and one prefix sum: run r starts at ends[r - 1]; 1 at each
    start inside the pack, inclusive cumsum, minus 1. Padded runs start at
    or after N and drop out."""
    Pg, _k = ends.shape
    starts, _e = _run_starts(ends)
    off = torch.arange(Pg, dtype=torch.int64, device=ends.device)[:, None] * N
    idx = torch.where(starts < N, starts + off, Pg * N)
    oneh = _scatter_add_rows(idx, torch.ones_like(idx, dtype=torch.int32),
                             Pg, N)
    oneh[:, 0] = 1
    return torch.cumsum(oneh, dim=1, dtype=torch.int32) - 1


def rle_expand_mask(ends: torch.Tensor, run_mask: torch.Tensor, N: int):
    """u32[Pg, k] exclusive run ends + bool[Pg, k] run verdicts -> bool[Pg,
    N] row mask, by boundary deltas and a prefix sum (no row gathers)."""
    Pg, _k = ends.shape
    starts, e = _run_starts(ends)
    off = torch.arange(Pg, dtype=torch.int64, device=ends.device)[:, None] * N
    big = Pg * N
    real = e <= N                       # padded runs have ends = 0xFFFFFFFF
    s_idx = torch.where(real & (starts < N), starts + off, big)
    e_idx = torch.where(real & (e < N), e + off, big)
    m = run_mask.to(torch.int32)
    delta = _scatter_add_rows(torch.cat([s_idx, e_idx], dim=1),
                              torch.cat([m, -m], dim=1), Pg, N)
    return torch.cumsum(delta, dim=1) > 0


def rle_expand_values(ends: torch.Tensor, run_values: torch.Tensor, N: int):
    """Decode RLE to rows by value-difference deltas and a prefix sum.

    run_values: int64 u64 bits [Pg, k] (the padded tail may repeat any
    value: padded runs start at or after N and drop out). Returns int64
    u64 bits [Pg, N]; differences and sums wrap mod 2^64."""
    Pg, _k = ends.shape
    starts, e = _run_starts(ends)
    prev = torch.cat([torch.zeros_like(run_values[:, :1]),
                      run_values[:, :-1]], dim=1)
    off = torch.arange(Pg, dtype=torch.int64, device=ends.device)[:, None] * N
    s_idx = torch.where((e <= N) & (starts < N), starts + off, Pg * N)
    acc = _scatter_add_rows(s_idx, run_values - prev, Pg, N)
    return torch.cumsum(acc, dim=1)


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
    constants of exec/rewrite.leaf_group_consts. Returns int32[Pg, W].

    Range-family modes (EQ, LT, LE, GT, GE, RANGE) over BITPACK planes
    (narrow and wide), ALP planes and DICT code planes arrive as "range"
    constants and run the ladder kernel (ops/scan_kernels.
    range_mask_count); NE and small IN lists stay on the ops/bitslice
    sweeps; IN lists of _IN_SORT_MIN_K keys
    or more take one merged sort (membership_bool) at any scheme."""
    N = W * 32
    not_in = mode == FilterMode.NOT_IN
    if g.scheme == Scheme.CONST:
        cm = consts["const_match"]
        return torch.zeros((g.npacks, W), dtype=torch.int32,
                           device=cm.device).masked_fill_(cm[:, None],
                                                          WD.FULL)

    if g.scheme in (Scheme.BITPACK, Scheme.DICT, Scheme.ALP):
        planes = g.arrays["planes"]
        if "range" in consts:
            return SK.range_mask_count(planes, *consts["range"], None,
                                       g.width)[0]
        if "dict_mask" in consts:
            # bytes IN / NOT_IN / REGEXP and big integer IN lists: a bool
            # verdict per dictionary entry, gathered by code
            return BS.pack_mask(S.dict_gather_mask(planes, g.width,
                                                   consts["dict_mask"]))
        if "cs_limbs" in consts:
            # big wide IN list: decode, rebase to absolute keyform, one
            # merged (L+1)-key sort membership
            from .join import _probe_bounds_merged_limbs
            lim = add_base_limbs(group_decode_limbs(g, W),
                                 consts["base_limbs"])
            csl = consts["cs_limbs"]
            lo, hi = _probe_bounds_merged_limbs(list(csl), list(lim))
            m = BS.pack_mask((hi > lo).reshape(g.npacks, N))
            return ~m if not_in else m
        if "cs" in consts:
            m = membership_words(*group_decode_halves(g, W), consts["cs"])
            return ~m if not_in else m
        kmode = _DICT_CODE_MODE[mode] if g.scheme == Scheme.DICT else mode
        if kmode in (FilterMode.IN, FilterMode.NOT_IN):
            m = B.in_planes_rel(planes, consts["rels"], g.width)
            return ~m if not_in else m
        return B.cmp_planes_rel(kmode, planes, consts["rel"], g.width)

    if g.scheme == Scheme.DELTA:
        bits = _delta_keys_impl(g)
        cs = consts.get("cs")
        if cs is not None and cs.shape[0] >= _IN_SORT_MIN_K:
            m = membership_words(*WD.halves_of_bits(bits), cs)
            return ~m if not_in else m
        return BS.pack_mask(_cmp_u64(mode, bits ^ WD.I64_MIN, consts))

    if g.scheme == Scheme.RLE:
        # evaluate on the run VALUES, expand by boundary deltas
        rv = g.arrays["values"].permute(1, 0, 2)        # [L, Pg, k]
        run_mask = _limb_mask_in_or_cmp(mode, rv, consts, g.nlimbs)
        return BS.pack_mask(rle_expand_mask(g.arrays["ends"], run_mask, N))

    if g.scheme == Scheme.RAW:
        x = g.arrays["values"].permute(1, 0, 2)         # [L, Pg, N]
        return BS.pack_mask(_limb_mask_in_or_cmp(mode, x, consts, g.nlimbs))

    raise ValueError(f"group_match: {g.scheme}")


def _delta_keys_impl(g: DeviceGroup) -> torch.Tensor:
    """DELTA planes -> int64 u64 bits [Pg, N]: zigzag decode, a row-wise
    prefix sum that wraps mod 2^64, plus each pack's first key."""
    zz = S.decode_bitplanes_u64(g.arrays["planes"], g.width)
    d = WD.lsr64(zz, 1) ^ (-(zz & 1))
    return torch.cumsum(d, dim=-1) + g.arrays["min_keys"][:, None]


def _cmp_u64(mode: FilterMode, keys, consts):
    """Compare decoded narrow keys in the order-preserving int64 form
    (ops/words.ordered_i64); "lo"/"hi" are python ints and "cs" an int64
    tensor of u64 bits, from exec/rewrite."""
    lo = consts.get("lo")
    if mode == FilterMode.EQ:
        return keys == lo
    if mode == FilterMode.NE:
        return keys != lo
    if mode == FilterMode.LT:
        return keys < lo
    if mode == FilterMode.LE:
        return keys <= lo
    if mode == FilterMode.GT:
        return keys > lo
    if mode == FilterMode.GE:
        return keys >= lo
    if mode == FilterMode.RANGE:
        return (keys >= lo) & (keys <= consts["hi"])
    if mode in (FilterMode.IN, FilterMode.NOT_IN):
        cs = consts["cs"] ^ WD.I64_MIN
        m = keys == cs[0]
        for i in range(1, cs.shape[0]):
            m = m | (keys == cs[i])
        return ~m if mode == FilterMode.NOT_IN else m
    raise ValueError(f"_cmp_u64: {mode}")


def _cmp_limbs(mode: FilterMode, x, consts):
    """Limb-domain compare via ops/cmp (works for wide types)."""
    if mode == FilterMode.RANGE:
        return C.between(x, consts["lo_limbs"], consts["hi_limbs"])
    if mode in (FilterMode.IN, FilterMode.NOT_IN):
        return C.match(mode, x, in_limbs=consts["cs_limbs"])
    return C.match(mode, x, lo=consts["lo_limbs"])


def _limb_mask_in_or_cmp(mode: FilterMode, x, consts, nlimbs: int):
    """_cmp_limbs, except that IN lists of _IN_SORT_MIN_K keys or more take
    the sort membership instead of the K-way EQ sweep (limb 0 is the most
    significant). Up to 2 limbs ride the two-word merged sort, wider values
    its L-limb generalization. Returns a bool mask of x.shape[1:]."""
    cs_l = consts.get("cs_limbs")
    if mode in (FilterMode.IN, FilterMode.NOT_IN) and cs_l is not None \
            and cs_l.shape[1] >= _IN_SORT_MIN_K:
        if nlimbs <= 2:
            vlo = x[nlimbs - 1]
            vhi = x[0] if nlimbs == 2 else torch.zeros_like(vlo)
            klo = cs_l[nlimbs - 1]
            khi = cs_l[0] if nlimbs == 2 else torch.zeros_like(klo)
            m = membership_bool(vlo, vhi, klo, khi)
        else:
            from .join import _probe_bounds_merged_limbs
            lo, hi = _probe_bounds_merged_limbs(list(cs_l), list(x))
            m = (hi > lo).reshape(x.shape[1:])
        return ~m if mode == FilterMode.NOT_IN else m
    return _cmp_limbs(mode, x, consts)


def membership_bool(vlo, vhi, klo, khi):
    """Bool membership mask (value in key set) from int32-carried u32 half
    pairs via ONE merged sort over [keys, rows] (exec/join.
    _probe_bounds_merged): a row is a member iff its (lo, hi) key-rank
    bounds differ. One fixed sequence of ops for any K."""
    from .join import _probe_bounds_merged
    lo, hi = _probe_bounds_merged(khi.reshape(-1), klo.reshape(-1),
                                  vhi.reshape(-1), vlo.reshape(-1))
    return (hi > lo).reshape(vlo.shape)


def membership_words(vlo, vhi, keys):
    """Packed membership mask int32[Pg, W] of value halves [Pg, N] in the
    int64 u64-bits key list `keys` (see membership_bool)."""
    klo, khi = WD.halves_of_bits(keys)
    return BS.pack_mask(membership_bool(vlo, vhi, klo, khi))


# --------------------------------------------------------------- decoding ---

def _limbs_to_halves(values: torch.Tensor):
    """int32-carried limbs [Pg, L, k] (L <= 2, most significant first) ->
    u64 halves (lo, hi) int32[Pg, k]: the reference's _limbs_to_u64."""
    if values.shape[1] == 1:
        lo = values[:, 0, :]
        return lo, torch.zeros_like(lo)
    return values[:, 1, :], values[:, 0, :]


def group_decode_halves(g: DeviceGroup, W: int):
    """Decode a group to u64 halves (lo int32[Pg, N], hi int32[Pg, N]),
    int32-carried: the value domain for narrow columns, the pack-relative
    domain for wide BITPACK and ALP groups (their bases are python ints).

    BITPACK: the bit-transpose decode plus each pack's min_key, with the
    carry out of the low word; CONST: the pack value broadcast; DICT: the
    codes looked up in the pack's value table with one torch.gather per
    half (the reference's one-hot matrix-unit lookups, onehot_lookup_u64
    and onehot_lookup_u16, are workarounds for a slow TPU gather and are
    not ported); bytes dictionaries (group ids come from their codes)
    decode to zeros; RAW: the stored limbs; DELTA: the wrapping prefix sum
    of the zigzag deltas; RLE: value differences scattered to the run
    starts and prefix-summed."""
    N = W * 32
    if g.wide and g.scheme != Scheme.BITPACK:
        raise ValueError(
            f"group_decode_halves: a wide {g.scheme.name} group holds more "
            f"than 64 bits per value; decode it with group_decode_limbs")
    if g.scheme == Scheme.CONST:
        lo, hi = _limbs_to_halves(g.arrays["values"][:, :, :1])
        return lo.expand(-1, N), hi.expand(-1, N)
    if g.scheme == Scheme.RAW:
        return _limbs_to_halves(g.arrays["values"])
    if g.scheme == Scheme.DELTA:
        return WD.halves_of_bits(_delta_keys_impl(g))
    if g.scheme == Scheme.RLE:
        rv = WD.bits_i64(*_limbs_to_halves(g.arrays["values"]))
        return WD.halves_of_bits(rle_expand_values(g.arrays["ends"], rv, N))
    if g.scheme == Scheme.DICT and g.dict_bytes is not None:
        # a bytes dictionary has no integer values: zeros, as the
        # reference's lookup of its placeholder table gives
        z = g.arrays["planes"].new_zeros((g.npacks, N))
        return z, z
    if g.scheme == Scheme.DICT:
        codes = S.decode_bitplanes_u32(g.arrays["planes"], g.width).long()
        vlo, vhi = _limbs_to_halves(g.arrays["values"])
        return (torch.gather(vlo, 1, codes), torch.gather(vhi, 1, codes))
    lo, hi = S.decode_bitplanes_pair(g.arrays["planes"], g.width)
    if g.wide or g.scheme == Scheme.ALP:
        return lo, hi
    mlo, mhi = (WD.u32_to_i64(h)[:, None]
                for h in WD.halves_of_bits(g.arrays["min_keys"]))
    s = WD.u32_to_i64(lo) + mlo
    carry = s >> 32
    return (WD.u32_from_i64(s & 0xFFFFFFFF),
            WD.u32_from_i64((WD.u32_to_i64(hi) + mhi + carry) & 0xFFFFFFFF))


def group_decode_keys(g: DeviceGroup, W: int) -> torch.Tensor:
    """Decode a group to its u64 keys as order-preserving int64 [Pg, N]
    (ops/words.ordered_i64): torch has no uint64, and searches and
    min/max need the order. Domains as group_decode_halves."""
    return WD.ordered_i64(*group_decode_halves(g, W))


def group_decode_limbs(g: DeviceGroup, W: int) -> torch.Tensor:
    """Decode any group to keyform limbs int32[L, Pg, N], most significant
    limb first (L = the column's nlimbs). Wide BITPACK groups give their
    pack-relative keys in the two low limbs under zero limbs; the host (or
    add_base_limbs) adds the python-int bases."""
    N = W * 32
    if g.scheme == Scheme.CONST:
        return S.decode_const(g.arrays["values"][:, :, :1], g.npacks, N)
    if g.scheme == Scheme.RAW:
        return S.decode_raw(g.arrays["values"])
    if g.scheme == Scheme.RLE:
        return S._gather_rows(g.arrays["values"],
                              rle_row_runs(g.arrays["ends"], N))
    if g.scheme == Scheme.DICT and g.dict_bytes is None:
        return S.decode_dict(g.arrays["planes"], g.arrays["values"], g.width)
    lo, hi = group_decode_halves(g, W)
    if g.nlimbs == 1:
        return lo[None]
    pads = [torch.zeros_like(hi)] * (g.nlimbs - 2)
    return torch.stack(pads + [hi, lo])


def add_base_limbs(lim: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Multi-limb add with carry: lim int32[L, Pg, N] + base int32[Pg, L]
    (int32-carried u32, limb 0 most significant) -> int32[L, Pg, N]; the
    carries ride int64 sums of u32 limbs. Rebases wide BITPACK packs to
    absolute keyform on the device."""
    L = lim.shape[0]
    out = [None] * L
    carry = torch.zeros(lim.shape[1:], dtype=torch.int64, device=lim.device)
    for l in range(L - 1, -1, -1):
        s = WD.u32_to_i64(lim[l]) + WD.u32_to_i64(base[:, l])[:, None] + carry
        out[l] = WD.u32_from_i64(s & 0xFFFFFFFF)
        carry = s >> 32
    return torch.stack(out)


def base_limbs(bases: list[int], nlimbs: int) -> np.ndarray:
    """Python-int pack bases -> u32[Pg, L], limb 0 most significant."""
    out = np.zeros((len(bases), nlimbs), np.uint32)
    for j, b in enumerate(bases):
        x = int(b)
        for l in range(nlimbs - 1, -1, -1):
            out[j, l] = x & 0xFFFFFFFF
            x >>= 32
    return out


def group_decode_limbs_abs(g: DeviceGroup, W: int) -> torch.Tensor:
    """group_decode_limbs with wide BITPACK groups rebased to ABSOLUTE
    keyform (ordered across packs). Wide CONST groups hold their keyform
    limbs already."""
    lim = group_decode_limbs(g, W)
    if g.wide and g.scheme == Scheme.BITPACK and g.bases:
        base = WD.to_words(base_limbs(g.bases, g.nlimbs), lim.device)
        lim = add_base_limbs(lim, base)
    return lim


def _lex_minmax(limbs, mask, want_min: bool):
    """Masked lexicographic min or max per pack: int32[L, Pg, N] -> int32[L,
    Pg], by a log-depth halving tournament on the row axis (an empty mask
    gives the fill value: all ones for min, zero for max)."""
    x = torch.where(mask[None], limbs, WD.FULL if want_min else 0)
    n = x.shape[-1]
    while n > 1:
        n //= 2
        a, b = x[..., :n], x[..., n:2 * n]
        take_b = C.lt_vec(b, a) if want_min else C.lt_vec(a, b)
        x = torch.where(take_b[None], b, a)
    return x[..., 0]


# ------------------------------------------------------------- aggregates ---

def group_masked_sum(g: DeviceGroup, mask_words):
    """Per-pack exact masked-sum partials; the host combines them with
    python ints (exec/scan._combine_sum). Always "cnt": int64[Pg], and:

    - BITPACK (narrow and wide) and ALP: "pcnt" int64[Pg, max(w,1)], the
      per-plane masked popcounts from the popcount kernel (the host adds
      min_key, the wide base or the ALP base times the count);
    - CONST: nothing more (the host multiplies the pack value);
    - wide RAW / RLE / DICT: "limb_sums" int64[L, Pg], per-limb sums;
    - narrow DELTA / RLE / RAW / DICT: "lo", "hi" int64[Pg], the sums of
      the value halves."""
    W = mask_words.shape[1]
    if g.scheme in (Scheme.BITPACK, Scheme.ALP):
        pcnt, cnt = SK.masked_plane_popcounts(g.arrays["planes"], mask_words,
                                              g.width)
        return {"pcnt": pcnt, "cnt": cnt}
    cnt = B.popcount_words(mask_words)
    if g.scheme == Scheme.CONST:
        return {"cnt": cnt}
    m = BS.unpack_mask(mask_words).to(torch.int64)
    if g.wide:
        limbs = group_decode_limbs(g, W)
        return {"limb_sums": (WD.u32_to_i64(limbs) * m[None]).sum(dim=-1),
                "cnt": cnt}
    lo, hi = group_decode_halves(g, W)
    return {"lo": (WD.u32_to_i64(lo) * m).sum(dim=-1),
            "hi": (WD.u32_to_i64(hi) * m).sum(dim=-1), "cnt": cnt}


def keyform_to_float(lo, hi, ft: FieldType):
    """Order-preserving float keyform (utils/limbs.to_keyform), as
    int32-carried u64 halves, -> the floats: FLOAT64 from both halves,
    FLOAT32 from the low word. A set top bit marks a value that was not
    negative (flip the bit back); a clear one a negative value (complement
    every bit). NaN comes back with the bits it went in with; -0.0 was
    stored as +0.0 (the host maps both zeros onto one key)."""
    if ft == FieldType.FLOAT32:
        return torch.where(lo < 0, lo ^ WD._I32_MIN, ~lo).view(torch.float32)
    k = WD.bits_i64(lo, hi)
    return torch.where(k < 0, k ^ WD.I64_MIN, ~k).view(torch.float64)


def pairwise_sum(vals: torch.Tensor) -> torch.Tensor:
    """Sum along the last axis (a power-of-two length) in the reference's
    fixed log-depth order: halve the axis, add the halves, repeat. IEEE
    additions in one fixed order give the same bits on every device."""
    n = vals.shape[-1]
    while n > 1:
        n //= 2
        vals = vals[..., :n] + vals[..., n:2 * n]
    return vals[..., 0]


def group_masked_sum_float(g: DeviceGroup, mask_words, ft: FieldType):
    """Per-pack masked float sums of a keyform float group (any scheme but
    ALP): {"fsum": float64 or float32 [Pg], "cnt": int64[Pg]}, reduced with
    pairwise_sum per pack, so a pack's sum depends on nothing but its rows
    and the mask."""
    W = mask_words.shape[1]
    lo, hi = group_decode_halves(g, W)
    vals = keyform_to_float(lo, hi, ft)
    vals = torch.where(BS.unpack_mask(mask_words), vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))
    return {"fsum": pairwise_sum(vals), "cnt": B.popcount_words(mask_words)}


def group_masked_minmax(g: DeviceGroup, mask_words):
    """Per-pack masked (min, max) partials; empty packs are gated on
    "cnt" int64[Pg] by the host (exec/scan._combine_minmax). And:

    - BITPACK (narrow and wide) and ALP: "mnmx" int32[Pg, 4] (mn_lo,
      mn_hi, mx_lo, mx_hi), pack-relative u32 halves from the plane
      tournament;
    - CONST: nothing more;
    - wide RAW / RLE / DICT: "mn_limbs", "mx_limbs" int32[L, Pg];
    - narrow DELTA / RLE / RAW / DICT: "mn", "mx" order-preserving
      int64[Pg] keys."""
    W = mask_words.shape[1]
    cnt = B.popcount_words(mask_words)
    if g.scheme == Scheme.CONST:
        return {"cnt": cnt}
    if g.scheme in (Scheme.BITPACK, Scheme.ALP):
        planes = g.arrays["planes"]
        mn = B._tournament_planes(planes, mask_words, g.width, want_max=False)
        mx = B._tournament_planes(planes, mask_words, g.width, want_max=True)
        return {"mnmx": torch.stack([*mn, *mx], dim=1), "cnt": cnt}
    mask = BS.unpack_mask(mask_words)
    if g.wide:
        limbs = group_decode_limbs(g, W)
        return {"mn_limbs": _lex_minmax(limbs, mask, want_min=True),
                "mx_limbs": _lex_minmax(limbs, mask, want_min=False),
                "cnt": cnt}
    keys = group_decode_keys(g, W)
    big = torch.iinfo(torch.int64)
    return {"mn": torch.where(mask, keys, big.max).min(dim=-1).values,
            "mx": torch.where(mask, keys, big.min).max(dim=-1).values,
            "cnt": cnt}
