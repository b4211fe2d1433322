"""Predicates and aggregates on bit-sliced (bitplane) packs, in PyTorch.

The port of knoxdb_tpu/ops/bitslice.py. Packs store values bit-sliced:
plane p of a pack is a word array where bit k of word j is bit p of row
j*32+k; planes are plane-major int32[w, P, W] (ops/words.py). A
predicate against a constant is an MSB-down BitWeaving-style ladder of
a few word ops per plane; the output is a packed bitset.

Constants never reach the device as u64: `_rel_const` relates a u64
keyform constant to every pack's packed domain on the host (numpy), and
`rel_to_device` uploads the result as per-plane select words (0 or ~0)
plus per-pack flags. Aggregates stay in the packed domain and come back
as exact partials for the host to combine: per-plane masked popcounts
(sum = Σ 2^p·c_p + min_key·count) and MSB-down tournament winners as u32
halves.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import FilterMode
from . import words as WD

__all__ = [
    "rel_to_device", "cmp_planes_rel", "range_planes_rel", "in_planes_rel",
    "match_planes", "popcount_words", "masked_sum_planes",
    "add_const_planes", "topk_select",
]

_U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def _rel_const(c, min_keys, width: int):
    """Relate a u64 keyform constant (scalar or per pack) to each pack's
    packed domain, on the host.

    Returns numpy (c_rel u64[P] clamped into [0, 2^width-1], lt_all
    bool[P], ge_none bool[P], in_dom bool[P]):
      lt_all:  every packed value < c  (c above the domain)
      ge_none: no packed value < c     (c at/below the domain base)
      in_dom:  c - min_key representable in `width` bits (EQ can match)
    """
    mk = np.asarray(min_keys, np.uint64)
    c = np.broadcast_to(np.asarray(c, np.uint64), mk.shape)
    maxp = np.uint64((1 << width) - 1) if width < 64 else _U64_MAX
    ge_min = c >= mk
    with np.errstate(over="ignore"):
        diff = np.where(ge_min, c - mk, np.uint64(0))
    lt_all = ge_min & (diff > maxp)
    ge_none = ~ge_min
    in_dom = ge_min & ~lt_all
    c_rel = np.where(in_dom, diff, np.uint64(0))
    return c_rel, lt_all, ge_none, in_dom


def const_bits(c_rel, width: int) -> np.ndarray:
    """u64[P] -> u32[P, max(width, 1)]: 0xFFFFFFFF where bit p of the
    constant is set, else 0 (the per-plane select words)."""
    c_rel = np.asarray(c_rel, np.uint64)
    out = np.zeros((c_rel.shape[0], max(width, 1)), np.uint32)
    for p in range(width):
        bit = ((c_rel >> np.uint64(p)) & np.uint64(1)) != 0
        out[:, p] = np.where(bit, np.uint32(0xFFFFFFFF), np.uint32(0))
    return out


def rel_to_device(rel, width: int, device):
    """Host relation (from _rel_const) -> (select words int32[P, w1],
    lt_all, ge_none, in_dom bool[P]) on `device`."""
    c_rel, lt_all, ge_none, in_dom = rel
    return (WD.to_words(const_bits(c_rel, width), device),
            *(torch.from_numpy(np.ascontiguousarray(a, bool)).to(device)
              for a in (lt_all, ge_none, in_dom)))


def _lt_eq_planes(planes, cbits, width: int):
    """Core MSB-down sweep -> (lt, eq) packed masks for x < c, x == c
    over the packed domain."""
    _, P, W = planes.shape
    lt = torch.zeros((P, W), dtype=torch.int32, device=planes.device)
    eq = torch.full((P, W), WD.FULL, dtype=torch.int32, device=planes.device)
    for p in range(width - 1, -1, -1):
        x = planes[p]
        c = cbits[:, p:p + 1]
        lt = lt | (eq & ~x & c)
        eq = eq & ~(x ^ c)
    return lt, eq


def cmp_planes_rel(mode: FilterMode, planes, rel, width: int):
    """Compare against a device relation (rel_to_device). Packs where the
    constant falls outside the packed domain take the flag overrides."""
    cbits, lt_all, ge_none, in_dom = rel
    lt_all, ge_none = lt_all[:, None], ge_none[:, None]
    out_dom = ~in_dom[:, None]

    if mode in (FilterMode.EQ, FilterMode.NE):
        eq = torch.full(planes.shape[1:], WD.FULL, dtype=torch.int32,
                        device=planes.device)
        for p in range(width):
            eq = eq & ~(planes[p] ^ cbits[:, p:p + 1])
        eq = eq.masked_fill(out_dom, 0)
        return ~eq if mode == FilterMode.NE else eq

    lt, eq = _lt_eq_planes(planes, cbits, width)
    if mode in (FilterMode.LT, FilterMode.GE):
        lt = lt.masked_fill(lt_all, WD.FULL).masked_fill(ge_none, 0)
        return lt if mode == FilterMode.LT else ~lt
    if mode in (FilterMode.LE, FilterMode.GT):
        le = lt | eq.masked_fill(out_dom, 0)
        le = le.masked_fill(lt_all, WD.FULL).masked_fill(ge_none, 0)
        return le if mode == FilterMode.LE else ~le
    raise ValueError(f"cmp_planes_rel: unsupported mode {mode!r}")


def range_planes_rel(planes, rel_lo, rel_hi, width: int):
    """lo <= x <= hi in ONE sweep over the planes."""
    lo_bits, lo_lt_all, lo_ge_none, _lo_in = rel_lo
    hi_bits, hi_lt_all, hi_ge_none, hi_in = rel_hi
    _, P, W = planes.shape
    dev = planes.device
    lt_lo = torch.zeros((P, W), dtype=torch.int32, device=dev)
    eq_lo = torch.full((P, W), WD.FULL, dtype=torch.int32, device=dev)
    lt_hi = torch.zeros((P, W), dtype=torch.int32, device=dev)
    eq_hi = torch.full((P, W), WD.FULL, dtype=torch.int32, device=dev)
    for p in range(width - 1, -1, -1):
        x = planes[p]
        cl, ch = lo_bits[:, p:p + 1], hi_bits[:, p:p + 1]
        lt_lo = lt_lo | (eq_lo & ~x & cl)
        eq_lo = eq_lo & ~(x ^ cl)
        lt_hi = lt_hi | (eq_hi & ~x & ch)
        eq_hi = eq_hi & ~(x ^ ch)
    lt_lo = lt_lo.masked_fill(lo_lt_all[:, None], WD.FULL)
    ge_lo = ~lt_lo.masked_fill(lo_ge_none[:, None], 0)
    le_hi = lt_hi | eq_hi.masked_fill(~hi_in[:, None], 0)
    le_hi = le_hi.masked_fill(hi_lt_all[:, None], WD.FULL)
    le_hi = le_hi.masked_fill(hi_ge_none[:, None], 0)
    return ge_lo & le_hi


def in_planes_rel(planes, rels, width: int):
    """x in set, given one device relation per key."""
    _, P, W = planes.shape
    eqs = [torch.full((P, W), WD.FULL, dtype=torch.int32,
                      device=planes.device) for _ in rels]
    for p in range(width - 1, -1, -1):
        x = planes[p]
        for k, r in enumerate(rels):
            eqs[k] = eqs[k] & ~(x ^ r[0][:, p:p + 1])
    acc = torch.zeros((P, W), dtype=torch.int32, device=planes.device)
    for eq, r in zip(eqs, rels):
        acc = acc | eq.masked_fill(~r[3][:, None], 0)
    return acc


def match_planes(mode: FilterMode, planes, min_keys, width: int,
                 lo=None, hi=None, cs=None):
    """Mode dispatch from host u64 constants: min_keys u64[P] (numpy);
    lo/hi u64 scalars or per-pack arrays; cs u64[K] or u64[K, P]."""
    dev = planes.device

    def rel(c):
        return rel_to_device(_rel_const(c, min_keys, width), width, dev)

    if mode == FilterMode.RANGE:
        return range_planes_rel(planes, rel(lo), rel(hi), width)
    if mode in (FilterMode.IN, FilterMode.NOT_IN):
        m = in_planes_rel(planes, [rel(k) for k in np.asarray(cs)], width)
        return ~m if mode == FilterMode.NOT_IN else m
    return cmp_planes_rel(mode, planes, rel(lo), width)


# ------------------------------------------------------------ aggregates ---

def popcount_words(words):
    """int32[..., W] -> int64[...] set-bit count over the last axis."""
    return WD.popcount(words).sum(dim=-1, dtype=torch.int64)


def masked_sum_planes(planes, mask_words, width: int):
    """Exact masked-sum partials WITHOUT decode: (pcnt int64[P, max(w,1)]
    with pcnt[:, p] = popcount(plane_p & mask), counts int64[P]). The
    host forms sum = Σ_p 2^p·pcnt[:, p] + min_key·count with python ints;
    width 0 gives one zero column."""
    counts = popcount_words(mask_words)
    if width == 0:
        return torch.zeros((mask_words.shape[0], 1), dtype=torch.int64,
                           device=mask_words.device), counts
    pcnt = torch.stack([popcount_words(planes[p] & mask_words)
                        for p in range(width)], dim=1)
    return pcnt, counts


def _tournament_planes(planes, mask_words, width: int, want_max: bool):
    """MSB-down candidate narrowing -> the packed-domain winner per pack as
    u32 halves (lo int32[P], hi int32[P]). An empty mask gives 0 for max
    and all ones in the low `width` bits for min; callers gate on count."""
    P = mask_words.shape[0]
    dev = mask_words.device
    cand = mask_words
    lo = torch.zeros(P, dtype=torch.int64, device=dev)
    hi = torch.zeros(P, dtype=torch.int64, device=dev)
    for p in range(width - 1, -1, -1):
        x = planes[p]
        t = cand & (x if want_max else ~x)
        has = (t != 0).any(dim=-1)
        cand = torch.where(has[:, None], t, cand)
        # max: bit set iff a candidate has it; min: bit set only when NO
        # candidate has a 0 there
        bit = (has if want_max else ~has).to(torch.int64)
        if p < 32:
            lo = lo | (bit << p)
        else:
            hi = hi | (bit << (p - 32))
    return WD.u32_from_i64(lo), WD.u32_from_i64(hi)


# ------------------------------------------------------------------ top-k ---

def add_const_planes(planes, const_bits, width_out: int):
    """Bit-sliced ripple-carry add of a PER-PACK constant.

    planes int32[w, P, W] (plane-major) encode x (pack-relative offsets);
    const_bits int32[width_out, P] holds bit b of each pack's constant as a
    full / zero word (computed on the host from pack metadata, where the
    bases are python ints). Returns int32[width_out, P, W], the bitplanes
    of (x + c) mod 2^width_out; planes past w read as zero.

    Cost: width_out sequential full-adder steps of [P, W] word ops, about
    two reads and one write of the plane volume."""
    w, P, W = planes.shape
    carry = torch.zeros((P, W), dtype=torch.int32, device=planes.device)
    out = torch.empty((width_out, P, W), dtype=torch.int32,
                      device=planes.device)
    for b in range(width_out):
        cb = const_bits[b][:, None]
        if b < w:
            xb = planes[b]
            x_cb = xb ^ cb
            out[b] = x_cb ^ carry
            carry = (xb & cb) | (carry & x_cb)
        else:
            out[b] = cb ^ carry
            carry = carry & cb
    return out


def topk_select(planes, mask_words, k, width: int, want_max: bool):
    """Exact top-k THRESHOLD and candidate masks by an MSB-first radix-4
    bit descent: ceil(width / 2) dependent steps of bucket popcounts over
    [P, W] words, with no sort of the row population.

    planes must lie in a domain that is COMPARABLE across packs (absolute
    keys minus a global base, see add_const_planes). k is a python int or
    a 0-dim integer tensor. The remaining count, the bucket counts and the
    threshold words stay 0-dim device tensors chosen with torch.where, so
    the chain never waits for the host.

    Returns (t_words: tuple of 0-dim int32-carried u32 words, least
    significant first; better int32[P, W]; tie int32[P, W]; n_better 0-dim
    int64): `better` rows beat the threshold T = Σ_j t_words[j] << 32j
    strictly, `tie` rows equal it; the top-k set is better plus any
    (k - n_better) tie rows. Works at any width (wide 128 / 256-bit
    keyform planes included)."""
    _, P, W = planes.shape
    dev = planes.device
    nw = -(-width // 32)
    pm = mask_words                      # rows still matching the prefix
    better = torch.zeros((P, W), dtype=torch.int32, device=dev)
    t_words = [torch.zeros((), dtype=torch.int64, device=dev)
               for _ in range(nw)]
    k_rem = torch.as_tensor(k, device=dev).to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def setbit(b, tbit):
        t_words[b // 32] = t_words[b // 32] | (tbit.to(torch.int64)
                                               << (b % 32))

    def pcount(m):
        return WD.popcount(m).sum(dtype=torch.int64)

    b = width - 1
    if width % 2:                        # odd width: one single-bit step
        x = planes[b]
        pref = pm & (x if want_max else ~x)
        rest = pm & (~x if want_max else x)
        c = pcount(pref)
        take = c >= k_rem
        pm = torch.where(take, pref, rest)
        better = torch.where(take, better, better | pref)
        k_rem = torch.where(take, k_rem, k_rem - c)
        setbit(b, take if want_max else ~take)
        b -= 1
    while b >= 1:
        # preferred-direction bit pair: after the conditional complement
        # "1" always means "sorts toward the top", so the bucket preference
        # is 3 > 2 > 1 > 0 whatever want_max is
        x1 = planes[b]
        x0 = planes[b - 1]
        if not want_max:
            x1 = ~x1
            x0 = ~x0
        g3 = pm & x1 & x0
        g2 = pm & x1 & ~x0
        g1 = pm & ~x1 & x0
        # one popcount pass over the three buckets (fewer launches)
        c3, c2, c1 = WD.popcount(torch.stack([g3, g2, g1])).sum(
            dim=(1, 2), dtype=torch.int64).unbind()
        cum2 = c3 + c2
        cum1 = cum2 + c1
        s3 = c3 >= k_rem
        s2 = (~s3) & (cum2 >= k_rem)
        s1 = (~s3) & (~s2) & (cum1 >= k_rem)
        in23 = s3 | s2
        in123 = in23 | s1
        pm = torch.where(s3, g3,
                         torch.where(s2, g2,
                                     torch.where(s1, g1, pm & ~x1 & ~x0)))
        better = better | torch.where(s3, 0, g3) \
            | torch.where(in23, 0, g2) | torch.where(in123, 0, g1)
        k_rem = k_rem - torch.where(s3, zero, c3) \
            - torch.where(in23, zero, c2) - torch.where(in123, zero, c1)
        # chosen bucket bits in the preferred space; the actual bit is the
        # preferred bit for max, its complement for min
        p1 = in23
        p0 = s3 | s1
        if not want_max:
            p1 = ~p1
            p0 = ~p0
        setbit(b, p1)
        setbit(b - 1, p0)
        b -= 2
    # the single-bit step leaves an even number of planes, so the pair
    # loop always lands exactly on planes (1, 0)
    return (tuple(WD.u32_from_i64(t) for t in t_words), better, pm,
            pcount(better))
