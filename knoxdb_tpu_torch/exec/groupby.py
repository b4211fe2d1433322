"""Group-by aggregation over device segments.

The port of knoxdb_tpu/exec/groupby.py. Group ids are materialized per
row from the compressed form without a hash table:
- DICT packs: a per-pack code -> global group LUT built on the host from
  the per-pack dictionaries (the union of the dictionaries is the group
  domain), applied as one gather;
- BITPACK/CONST packs with a dense global key range: gid = key - min;
- sparse key sets: a search of the row keys in the sorted domain;
- time buckets: gid = (ts - t0) // interval (series path).

Then per-group exact aggregation runs in one of two routes:
- count and sum (`group_count_sum`, `group_moments_exact`): the CUDA
  group kernels of ops/group_kernels.py, with exact int64 sums of the u32
  value halves, at every G <= MAX_GROUPS;
- count, sum, min and max (`group_aggregate`): plain torch scatters.

Group cardinality is fixed per query from host metadata (dictionaries
and zone maps). u64 keys live on the device as int32-carried halves or as
order-preserving int64 (ops/words.py): torch has no uint64 arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..encode import schemes as S
from ..encode.schemes import Scheme
from ..ops import bitset as BS
from ..ops import group_kernels as GK
from ..ops import words as WD
from ..types import FieldType
from . import device as D

__all__ = ["GroupPlan", "plan_groups", "plan_buckets", "segment_group_keys",
           "gid_consts", "row_gids", "chunk_plan", "mxu_chunk_sums",
           "square_halves", "halves_sum", "group_count_sum",
           "group_moments_exact", "group_aggregate", "MAX_GROUPS"]

MAX_GROUPS = 1 << 16
_I64_MAX = (1 << 63) - 1
_OVER = 1 << 30         # gid of rows past the last bucket (any gid >= G drops)


@dataclass
class GroupPlan:
    """Host-side group domain for one segment + group column."""
    keys: np.ndarray            # u64[G] or object[G]: group keyform keys
    G: int
    # per device group, the gid recipe: ("lut", lut u32[Pg, k]) |
    # ("const", gids u32[Pg]) | ("range", gmin) | ("search", keys u64[G]) |
    # (bucket tag, t0 u64, interval u64)
    mode: list

    def key_values(self, ft: FieldType):
        from ..utils import limbs as lb
        if ft.is_bytes_like:
            if ft == FieldType.STRING:
                return np.array([b.decode() for b in self.keys], object)
            return np.array(list(self.keys), object)
        if ft.nlimbs <= 2:
            L = ft.nlimbs
            limbs = np.zeros((L, self.G), np.uint32)
            for i, k in enumerate(self.keys):
                kk = int(k)
                for l in range(L - 1, -1, -1):
                    limbs[l, i] = kk & 0xFFFFFFFF
                    kk >>= 32
            return lb.from_keyform(limbs, ft)
        bias = 1 << (ft.bits - 1) if ft.is_signed else 0
        return np.array([int(k) - bias for k in self.keys], object)


def plan_groups(dseg: D.DeviceSegment, fname: str,
                global_keys: np.ndarray | None = None) -> GroupPlan:
    """Build the group domain + per-device-group gid recipe.

    global_keys: optional externally imposed domain (the union over
    several segments); sorted keyform u64, or sorted bytes for STRING and
    BYTES columns."""
    from .rewrite import _pack_const_value
    col = dseg.seg.columns[fname]
    dcol = dseg.column(fname)
    if global_keys is None:
        global_keys = segment_group_keys(dseg, fname)
    G = len(global_keys)
    if G > MAX_GROUPS:
        raise ValueError(
            f"group-by {fname}: {G} groups exceeds MAX_GROUPS={MAX_GROUPS}; "
            f"use a bucket expression or a lower-cardinality key")
    if col.wide:
        raise ValueError(f"group-by {fname}: wide (>64-bit) group keys are "
                         f"not supported; bucket or dict-encode first")
    is_bytes = col.field.type.is_bytes_like
    key_index = {k: i for i, k in enumerate(global_keys)} if is_bytes else None
    modes = []
    for g in dcol.groups:
        if g.scheme == Scheme.DICT:
            lut = np.zeros((g.npacks, g.k), np.uint32)
            for j in range(g.npacks):
                if is_bytes:
                    gid = np.array([key_index[b] for b in g.dict_bytes[j]],
                                   np.uint32)
                else:
                    gid = np.searchsorted(global_keys,
                                          g.dict_keys[j]).astype(np.uint32)
                lut[j, :len(gid)] = gid
                lut[j, len(gid):] = gid[-1] if len(gid) else 0
            modes.append(("lut", lut))
        elif g.scheme == Scheme.CONST:
            vals = np.array([_pack_const_value(col, g, j)
                             for j in range(g.npacks)], np.uint64)
            gids = np.searchsorted(global_keys, vals).astype(np.uint32)
            modes.append(("const", gids))
        else:
            dense = (not is_bytes and G > 0
                     and int(global_keys[-1]) - int(global_keys[0]) + 1 == G)
            if dense:
                modes.append(("range", int(global_keys[0])))
            else:
                modes.append(("search", global_keys.astype(np.uint64)))
    return GroupPlan(global_keys, G, modes)


def plan_buckets(dseg: D.DeviceSegment, fname: str, t0: int, interval: int,
                 G: int) -> GroupPlan:
    """Time-bucket grouping: gid = (key - t0) // interval for keys in
    [t0, t0 + G*interval); rows below t0 get -1 and rows above a gid >= G
    (both dropped). Tags: when the in-range domain G*interval fits 31 bits
    the gid computes from u32 halves ("bucket32"), with a shift for a
    power-of-two interval ("bucket32s:<k>"); otherwise "bucket"."""
    dcol = dseg.column(fname)
    keys = np.arange(G, dtype=np.uint64) * np.uint64(interval) + np.uint64(t0)
    fits32 = G * interval < (1 << 31)
    if fits32 and interval & (interval - 1) == 0:
        tag = f"bucket32s:{interval.bit_length() - 1}"
    elif fits32:
        tag = "bucket32"
    else:
        tag = "bucket"
    modes = [(tag, np.uint64(t0), np.uint64(interval))
             for _ in dcol.groups]
    return GroupPlan(keys, G, modes)


def segment_group_keys(dseg: D.DeviceSegment, fname: str) -> np.ndarray:
    """Group key domain of one segment from host metadata only."""
    col = dseg.seg.columns[fname]
    dcol = dseg.column(fname)
    fs = dseg.seg.stats.fields[fname]
    if col.field.type.is_bytes_like:
        alls: set = set()
        for g in dcol.groups:
            for db in g.dict_bytes:
                alls.update(db)
        return np.array(sorted(alls), object)
    keysets = []
    dense_range = False
    for g in dcol.groups:
        if g.scheme == Scheme.DICT:
            keysets.extend(g.dict_keys)
        else:
            dense_range = True
    if dense_range:
        # empty packs carry zero stats: leave them out of the range
        mk, xk = fs.min_key, fs.max_key
        nr = np.asarray(getattr(dseg.seg.stats, "nrows", ()))
        if nr.shape == mk.shape and (nr > 0).any():
            mk, xk = mk[nr > 0], xk[nr > 0]
        gmin = int(np.min(mk))
        gmax = int(np.max(xk))
        if gmax - gmin + 1 > MAX_GROUPS:
            raise ValueError(
                f"group-by {fname}: key range {gmax - gmin + 1} too wide for "
                f"dense grouping; dict-encode the column or bucket it")
        keysets.append(np.arange(gmin, gmax + 1, dtype=np.uint64))
    return np.unique(np.concatenate(keysets).astype(np.uint64))


def gid_consts(gplan: GroupPlan, device):
    """Per-device-group operands of row_gids (the tags select the code):
    LUT and CONST gids as int32 tensors; bucket32 (t0, interval) and range
    gmin as python ints; search keys and the bucket starts t0 + i*interval
    (i <= G, those below 2^64) as sorted order-preserving int64 tensors."""
    out = []
    for m in gplan.mode:
        if m[0] in ("lut", "const"):
            out.append(torch.from_numpy(
                np.asarray(m[1], np.int64).astype(np.int32)).to(device))
        elif m[0] == "bucket":
            t0, iv = int(m[1]), int(m[2])
            starts = [t0 + i * iv for i in range(gplan.G + 1)]
            starts = np.array([s for s in starts if s < 1 << 64], np.uint64)
            out.append(torch.from_numpy(WD.ordered_from_u64(starts))
                       .to(device))
        elif m[0].startswith("bucket32"):
            out.append((int(m[1]), int(m[2])))
        elif m[0] == "range":
            out.append(int(m[1]))
        else:
            out.append(torch.from_numpy(WD.ordered_from_u64(m[1]))
                       .to(device))
    return out


def _sub_halves(lo, hi, c: int):
    """u64 halves minus the python int c < 2^64, as int64 halves in
    [0, 2^32) (borrow arithmetic; nothing overflows)."""
    d_lo = WD.u32_to_i64(lo) - (c & 0xFFFFFFFF)
    borrow = (d_lo < 0).to(torch.int64)
    d_lo = d_lo + (borrow << 32)
    d_hi = (WD.u32_to_i64(hi) - (c >> 32) - borrow) & 0xFFFFFFFF
    return d_lo, d_hi


def row_gids(mode_tags: tuple, groups: list, gconsts, P: int, W: int):
    """Materialize gid int32[P, N] for the whole segment. Ids are exact
    in [0, G); other rows get -1 or an id >= G."""
    outs = []
    for tag, g, gc in zip(mode_tags, groups, gconsts):
        if tag == "lut":
            codes = S.decode_bitplanes_u32(g.arrays["planes"], g.width)
            gid = torch.gather(gc, 1, codes.long())
        elif tag == "const":
            gid = gc[:, None].expand(-1, W * 32)
        elif tag.startswith("bucket32"):
            t0, iv = gc
            lo, hi = D.group_decode_halves(g, W)
            below = WD.ordered_i64(lo, hi) < int(WD.ordered_from_u64(t0))
            rel_lo, rel_hi = _sub_halves(lo, hi, t0)
            if tag.startswith("bucket32s:"):
                g32 = rel_lo >> int(tag.split(":")[1])
            else:
                g32 = rel_lo // iv
            # in-range rels fit 31 bits (plan-guaranteed); the rest lie
            # past the last bucket
            g32 = torch.where(rel_hi == 0, g32.clamp(max=_OVER), _OVER)
            gid = torch.where(below, -1, g32)
        elif tag == "bucket":
            keys = D.group_decode_keys(g, W)
            gid = torch.searchsorted(gc, keys, right=True) - 1
        elif tag == "range":
            lo, hi = D.group_decode_halves(g, W)
            d_lo, d_hi = _sub_halves(lo, hi, gc)
            gid = torch.where((d_hi == 0) & (d_lo < 1 << 31), d_lo, -1)
        else:
            gid = torch.searchsorted(gc, D.group_decode_keys(g, W))
        outs.append(gid.to(torch.int32))
    if len(outs) == 1 and groups[0].npacks == P:
        return outs[0].contiguous()     # single full-coverage group
    full = outs[0].new_zeros((P, W * 32))
    for gid, g in zip(outs, groups):
        full[g.idx_t] = gid
    return full


def _value_halves(value_pair, bias: int):
    """(lo, hi) int32-carried u64 halves minus the chunk_plan bias, in u32
    borrow arithmetic."""
    lo, hi = value_pair
    if not bias:
        return lo, hi
    d_lo, d_hi = _sub_halves(lo, hi, bias)
    return WD.u32_from_i64(d_lo), WD.u32_from_i64(d_hi)


def square_halves(rlo):
    """Exact r^2 as int32-carried (lo, hi) halves for r = rlo < 2^32, from
    16-bit limbs in int64 (every product < 2^32): r = a + 2^16 b, so
    r^2 = a^2 + 2^17 ab + 2^32 b^2."""
    r = WD.u32_to_i64(rlo)
    a = r & 0xFFFF
    b = r >> 16
    p1 = a * b
    t = a * a + ((p1 & 0x7FFF) << 17)
    lo = t & 0xFFFFFFFF
    hi = b * b + (p1 >> 15) + (t >> 32)
    return WD.u32_from_i64(lo), WD.u32_from_i64(hi)


def chunk_plan(fstats) -> tuple[int, int]:
    """(n_chunks, bias) from a column's zone maps: values rebased by
    `bias` fit n_chunks*8 bits. The series path takes its exact moments
    route when n_chunks <= 4 (rebased values below 2^32, so their squares
    are exact in two u32 halves). (8, 0) when stats are missing or
    wide."""
    if fstats is None or fstats.min_key.dtype == object:
        return 8, 0
    gmin = int(fstats.min_key.min())
    gmax = int(fstats.max_key.max())
    c0 = max(1, -(-gmax.bit_length() // 8))
    cb = max(1, -(-(gmax - gmin).bit_length() // 8))
    if cb < min(c0, 8):
        return cb, gmin
    return min(c0, 8), 0


def mxu_chunk_sums(chunks) -> np.ndarray:
    """The reference's host recombination of byte (or 16 nibble) chunk
    sums into exact python-int sums, object ndarray [G]; kept to hold the
    exact-halves kernels against the reference's chunk form."""
    cs = [np.asarray(c).astype(object) for c in chunks]
    shift = 4 if len(cs) == 16 else 8
    out = cs[0].copy()
    for c in range(1, len(cs)):
        out += cs[c] << (shift * c)
    return out


def halves_sum(s_lo, s_hi) -> np.ndarray:
    """int64 sums of u32 halves -> exact python-int sums, object [G]."""
    return (s_lo.cpu().numpy().astype(object)
            + (s_hi.cpu().numpy().astype(object) << 32))


def group_count_sum(gids, mask_words, value_pair, G: int):
    """Per-group exact (counts, Σlo, Σhi) int64[G] through the group kernel
    at every G <= MAX_GROUPS: the counterpart of the reference's
    _group_pallas / group_aggregate_mxu, whose per-tile byte chunks the
    kernel replaces by exact half sums (ops/group_kernels.py)."""
    vlo, vhi = value_pair
    return GK.fused_group_partials(gids.contiguous(), mask_words.contiguous(),
                                   vlo.contiguous(), vhi.contiguous(), G)


def group_moments_exact(gids, mask_words, rpair, qpair, G: int):
    """Per-group (counts, Σrlo, Σrhi, Σqlo, Σqhi) int64[G] in one pass of
    the moments kernel: the counterpart of the reference's
    group_moments_mxu."""
    return GK.fused_group_moments_partials(
        gids.contiguous(), mask_words.contiguous(),
        *(t.contiguous() for t in (*rpair, *qpair)), G)


def group_aggregate(gids, mask_words, value_keys, G: int):
    """Per-group exact aggregation with min and max, in plain torch.

    gids int32[P, N]; mask_words int32[P, W]; value_keys int64[P, N]
    order-preserving keys (ops/words.ordered_i64). Returns (counts
    int64[G], sum_lo int64[G], sum_hi int64[G], mn int64[G], mx int64[G])
    with sum = sum_lo + sum_hi * 2^32 over the u64 keys, and mn/mx as
    order-preserving keys; empty groups read mn = u64 max, mx = 0. The
    reference sorts because XLA on the TPU scatters slowly; here scatters
    (index_add_, scatter_reduce) are the direct method."""
    ok = BS.unpack_mask(mask_words) & (gids >= 0) & (gids < G)
    idx = gids[ok].long()
    k = value_keys[ok]
    lo = k & 0xFFFFFFFF
    hi = ((k >> 32) & 0xFFFFFFFF) ^ 0x80000000
    dev = gids.device

    def zeros():
        return torch.zeros(G, dtype=torch.int64, device=dev)

    counts = zeros().index_add_(0, idx, torch.ones_like(idx))
    sum_lo = zeros().index_add_(0, idx, lo)
    sum_hi = zeros().index_add_(0, idx, hi)
    mn = torch.full((G,), _I64_MAX, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, idx, k, "amin")
    mx = torch.full((G,), -_I64_MAX - 1, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, idx, k, "amax")
    return counts, sum_lo, sum_hi, mn, mx
