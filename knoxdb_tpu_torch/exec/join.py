"""Equi-joins over keyform keys: the single-chip sort-probe join.

The port of knoxdb_tpu/exec/join.py, with the same names, outputs and
conventions: every core returns its pairs INTERSPERSED in merged key
order, -2 at the positions that hold no pair and ridx -1 on LEFT misses;
`join_pairs_device` filters them and runs the reference's core ladder.

Carrying keys in torch, which has no uint32 or uint64 sort:
- Join keys are int64 tensors holding the u64 bits of the common join
  domain. A key sorts in u64 order as `key ^ 2^63` (ops/words.ordered_i64
  reading); with keys32 only its low 32 bits take part.
- u32 words of the cores (ids, the side tag bit, counts, SENT) are int64
  tensors holding values in [0, 2^32), so every compare is the unsigned
  one; outputs keep the reference's int32 / int64 dtypes.

Every sort of the reference has one deterministic result, and the port
reproduces it array for array: either the sort keys are distinct (the
merged sort's composite of key, side tag and row id; the build sort's
iota), or the reference relies on XLA sorting stably (it passes no
is_stable=True, and XLA's sort keeps ties in input order), and the port
sorts with stable=True. Two TPU rules do not bind here and the port drops
them while keeping each contract: the log-doubling fills (lax.cummax
overflowed VMEM; here a blocked torch.cummax) and "zero
gathers / zero searchsorteds" (the probe-order restore sort is a scatter
here).

The host oracle `join_keys_np` stays numpy, vectorized with the output
the reference's row loop gives.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import JoinType

__all__ = ["JoinResult", "join_keys_np", "SHIFT_S", "join_pairs_device",
           "join_count_device", "merge_sorted_stable",
           "join_pairs_core_unique", "join_pairs_core_shift",
           "join_pairs_core"]

SHIFT_S = 16     # shift-core span: covers key runs up to 17 entries
SENT = 0xFFFFFFFF
TAGBIT = 1 << 31
_I64_MIN = -(1 << 63)


class JoinResult:
    def __init__(self, lidx: np.ndarray, ridx: np.ndarray):
        self.lidx = lidx      # row indices into the left batch (-1 = none)
        self.ridx = ridx      # row indices into the right batch (-1 = none)

    @property
    def n(self) -> int:
        return len(self.lidx)


def join_keys_np(lkeys: np.ndarray, rkeys: np.ndarray,
                 how: JoinType = JoinType.INNER) -> JoinResult:
    """Join two keyform key arrays (u64 or object ints).

    Host reference implementation (also the oracle for the device path):
    sort-probe with duplicate expansion. Returns matched index pairs in
    left-row order (stable), each probe's matches in ascending build order
    of the stable key sort, with -1 on the outer side's misses; RIGHT and
    FULL append the unmatched build rows in ascending order."""
    order = np.argsort(rkeys, kind="stable")
    rs = rkeys[order]
    lo = np.searchsorted(rs, lkeys, side="left")
    hi = np.searchsorted(rs, lkeys, side="right")
    counts = (hi - lo).astype(np.int64)

    if how == JoinType.CROSS:
        li = np.repeat(np.arange(len(lkeys)), len(rkeys))
        ri = np.tile(np.arange(len(rkeys)), len(lkeys))
        return JoinResult(li, ri)

    outer_l = how in (JoinType.LEFT, JoinType.FULL)
    eff = np.maximum(counts, 1) if outer_l else counts
    lidx = np.repeat(np.arange(len(lkeys), dtype=np.int64), eff)
    # rank of each slot within its probe's run of slots
    starts = np.cumsum(eff) - eff
    k = np.arange(len(lidx), dtype=np.int64) - np.repeat(starts, eff)
    hit = np.repeat(counts > 0, eff)
    ridx = np.full(len(lidx), -1, np.int64)
    ridx[hit] = order[np.repeat(lo, eff)[hit] + k[hit]]
    if how in (JoinType.RIGHT, JoinType.FULL):
        matched_r = np.zeros(len(rkeys), bool)
        matched_r[ridx[hit]] = True
        miss = np.flatnonzero(~matched_r).astype(np.int64)
        lidx = np.concatenate([lidx, np.full(len(miss), -1, np.int64)])
        ridx = np.concatenate([ridx, miss])
    return JoinResult(lidx, ridx)


# ------------------------------------------------------------ helpers ---

def _u32(t: torch.Tensor) -> torch.Tensor:
    """A u32 word (int32-carried or already a value) -> int64 in
    [0, 2^32)."""
    return t.to(torch.int64) & 0xFFFFFFFF


def _run_starts(k: torch.Tensor) -> torch.Tensor:
    """True where a key run of the sorted k starts (position 0 always)."""
    start = torch.ones_like(k, dtype=torch.bool)
    start[1:] = k[1:] != k[:-1]
    return start


_SCAN_ROW = 1024


def _fill_forward_max(vals: torch.Tensor) -> torch.Tensor:
    """Inclusive running maximum of an integer tensor (the reference's
    log-doubling max). torch.cummax of a 1-d CUDA tensor scans it in one
    block (25 ms for 8,388,608 int64 on an H100), so the scan runs over
    rows of _SCAN_ROW in parallel, then over the rows' maxima, and each
    row takes the maximum of the rows before it."""
    n = vals.shape[0]
    if n <= _SCAN_ROW:
        return torch.cummax(vals, 0).values
    rows = -(-n // _SCAN_ROW)
    low = torch.iinfo(vals.dtype).min
    v = torch.cat([vals, vals.new_full((rows * _SCAN_ROW - n,), low)])
    local = torch.cummax(v.view(rows, _SCAN_ROW), 1).values
    carry = _fill_forward_max(local[:, -1])
    prev = torch.cat([carry.new_full((1,), low), carry[:-1]])
    return torch.maximum(local, prev[:, None]).view(-1)[:n]


def _fill_forward_last(vals: torch.Tensor, sent) -> torch.Tensor:
    """Forward-fill: each position takes the nearest preceding (or own)
    value != sent; positions with no predecessor keep sent. The running
    maximum of the positions that hold a value, then one gather."""
    n = vals.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=vals.device)
    last = _fill_forward_max(torch.where(vals != sent, pos, -1))
    got = vals[last.clamp(min=0)]
    return torch.where(last >= 0, got, torch.full_like(vals, sent))


def merge_sorted_stable(na: int, key: torch.Tensor, *payloads):
    """Stable merge of two concatenated ascending runs key[:na] and
    key[na:] with payload channels: equal keys keep concatenation order.
    Implemented as the stable sort, as the reference implements it. key:
    an integer tensor whose signed order is the intended one (u32 values
    in int64). Returns (key_sorted, *payloads_sorted)."""
    ks, perm = torch.sort(key, stable=True)
    return (ks,) + tuple(p[perm] for p in payloads)


def _merged_sort_tagged(lkeys, rkeys, keys32: bool):
    """ONE merged sort of [build ∪ probe] with the side tag riding bit 31
    of the id word (builds sort first within a key run). Returns
    ((key_sorted,), pidt_s int64 holding the u32 tagged ids).

    keys32: the u64 composite (key_lo << 32) | pidt is distinct per entry;
    with bit 63 flipped it sorts as one int64 and decodes back without a
    gather. 64-bit keys: the reference sorts (hi, lo, pidt) as three keys.
    pidt ascends in concatenation order (build ids sit below TAGBIT | probe
    id), so a STABLE sort on the ordered 64-bit key alone gives the same
    order; this depends on the input order built here."""
    dev = lkeys.device
    Nr, Nl = rkeys.shape[0], lkeys.shape[0]
    pidt = torch.cat([torch.arange(Nr, dtype=torch.int64, device=dev),
                      torch.arange(Nl, dtype=torch.int64, device=dev)
                      | TAGBIT])
    keys = torch.cat([rkeys, lkeys])
    if keys32:
        comp = ((keys & 0xFFFFFFFF) - (1 << 31)) * (1 << 32) + pidt
        cs = torch.sort(comp).values
        return ((cs >> 32) + (1 << 31),), cs & 0xFFFFFFFF
    ks, perm = torch.sort(keys ^ _I64_MIN, stable=True)
    return (ks,), pidt[perm]


def _probe_bounds_merged(rs_hi, rs_lo, qk_hi, qk_lo):
    """BOTH probe bounds (lo = builds strictly below, hi = builds <=) from
    ONE merged sort of the sorted build keys and the query keys, u32 limbs
    (int32-carried or int64 values). Builds sort before equal-key queries,
    so at a query's slot the exclusive build count IS hi; lo is the build
    count at the slot's key-run start, forward-filled with a running
    maximum. Returns (lo, hi) int32[Nq] in query order."""
    kh = torch.cat([_u32(rs_hi), _u32(qk_hi)])
    kl = torch.cat([_u32(rs_lo), _u32(qk_lo)])
    return _merged_bounds(rs_hi.shape[0], qk_hi.shape[0],
                          [(kh - (1 << 31)) * (1 << 32) + kl])


def _probe_bounds_merged_limbs(b_cols, q_cols):
    """L-limb generalization of _probe_bounds_merged (MSW-first u32 limb
    lists, any shapes, flattened): build-rank bounds per query. The
    merged lexicographic sort is L stable sorts, least significant limb
    first."""
    cols = [torch.cat([_u32(b).reshape(-1), _u32(q).reshape(-1)])
            for b, q in zip(b_cols, q_cols)]
    return _merged_bounds(b_cols[0].numel(), q_cols[0].numel(), cols)


def _merged_bounds(Nb: int, Nq: int, cols):
    """Shared body of the two bound functions. cols: the concatenated
    [build ∪ query] sort keys, most significant first, each an int64
    whose signed order is the intended one. Every stable sort keeps the
    builds (first in the input) ahead of equal-key queries, which is the
    reference's tag key."""
    dev = cols[0].device
    M = Nb + Nq
    perm = torch.arange(M, dtype=torch.int64, device=dev)
    for c in reversed(cols):
        perm = perm[torch.sort(c[perm], stable=True).indices]
    is_q = perm >= Nb
    pos = torch.arange(M, dtype=torch.int64, device=dev)
    cq = torch.cumsum(is_q, 0)                           # inclusive
    bb = pos + 1 - cq - (~is_q).to(torch.int64)          # builds before
    start = torch.zeros(M, dtype=torch.bool, device=dev)
    start[0] = True
    for c in cols:
        cs = c[perm]
        start[1:] |= cs[1:] != cs[:-1]
    lo_all = _fill_forward_max(torch.where(start, bb, 0))
    # restore query order: the reference's sort on (query id | Nq) is a
    # scatter of the query slots to their ids
    qid = perm[is_q] - Nb
    lo = torch.empty(Nq, dtype=torch.int32, device=dev)
    hi = torch.empty(Nq, dtype=torch.int32, device=dev)
    lo[qid] = lo_all[is_q].to(torch.int32)
    hi[qid] = bb[is_q].to(torch.int32)
    return lo, hi


def _merged_bounds_inorder(lkeys, rkeys, keys32: bool = False):
    """ONE merged sort of [build ∪ probe] -> per-MERGED-position arrays
    (is_probe bool[M], probe id int32[M], lo int32[M], hi int32[M]): lo/hi
    are the probe's build-rank bounds, valid at probe positions. The side
    tag rides bit 31 of the id word, so probe ids arrive as payloads and
    no probe-order restore is needed."""
    (k,), pidt_s = _merged_sort_tagged(lkeys, rkeys, keys32)
    M = k.shape[0]
    is_q = (pidt_s & TAGBIT) != 0
    pid = (pidt_s & ~TAGBIT).to(torch.int32)
    pos = torch.arange(M, dtype=torch.int64, device=k.device)
    cq = torch.cumsum(is_q, 0)                           # inclusive
    bb = pos + 1 - cq - (~is_q).to(torch.int64)          # builds before
    # builds sort before equal-key probes, so at a probe slot the
    # exclusive build count IS hi; lo is the run-start build count,
    # forward-filled
    lo = _fill_forward_max(torch.where(_run_starts(k), bb, 0))
    return is_q, pid, lo.to(torch.int32), bb.to(torch.int32)


def join_pairs_core_unique(lkeys, rkeys, how: JoinType = JoinType.INNER,
                           keys32: bool = False):
    """Sort-probe join for a UNIQUE build side (e.g. joining on the build
    table's pk): every probe has at most one match. ONE merged sort and
    one forward fill: in merged order, key-run ids come from the run
    starts (cumsum); each probe takes the nearest preceding build's (id,
    run id) and matches iff that run id is its own.

    Returns (lidx int32[Nl+Nr], ridx int32[Nl+Nr], total int64, dup_builds
    bool), pairs interspersed in key order (build rows and non-matching
    probes -2, LEFT misses ridx -1). dup_builds=True means a build key
    repeats: the results then undercount and the caller must run the
    general core."""
    Nl, Nr = lkeys.shape[0], rkeys.shape[0]
    assert Nl < (1 << 30) and Nr < (1 << 30)
    left = how == JoinType.LEFT
    (k,), pidt_s = _merged_sort_tagged(lkeys, rkeys, keys32)
    is_b = (pidt_s & TAGBIT) == 0
    pid_s = pidt_s & ~TAGBIT
    start = _run_starts(k)
    seg = torch.cumsum(start, 0)                         # run id, >= 1
    # a build NOT at its run start can only follow another build of the
    # same key (builds sort first in-run)
    dup_builds = (is_b & ~start).any()
    fb = _fill_forward_last(torch.where(is_b, pid_s, SENT), SENT)
    fs = _fill_forward_last(torch.where(is_b, seg, SENT), SENT)
    match = (~is_b) & (fs == seg) & (fb != SENT)
    li = pid_s.to(torch.int32)
    bid = fb.to(torch.int32)
    if left:
        lidx = torch.where(is_b, -2, li)
        ridx = torch.where(is_b, -2, torch.where(match, bid, -1))
        total = torch.tensor(Nl, dtype=torch.int64, device=k.device)
    else:
        lidx = torch.where(match, li, -2)
        ridx = torch.where(match, bid, -2)
        total = match.sum(dtype=torch.int64)
    return lidx, ridx, total, dup_builds


def join_pairs_core_shift(lkeys, rkeys, S: int = 16,
                          how: JoinType = JoinType.INNER,
                          keys32: bool = False):
    """General dup-expansion join for bounded key-run spans: ONE merged
    sort + S shifted equal-key compares. After the merged sort a key run
    is [builds..., probes...]; every (probe, build) pair of a run sits at
    a unique distance s in [1, span-1], so shift s emits exactly the pairs
    at that distance: valid(p, s) = probe(p) & build(p-s) & key[p] ==
    key[p-s].

    Returns (lidx int32[C*M], ridx int32[C*M], total int64, maxneed
    int32), C = min(S, M-1) (+1 for LEFT's miss channel), M = Nl + Nr;
    pairs interspersed (-2 elsewhere, LEFT misses ridx -1 in the extra
    channel). maxneed is the largest distance a matched probe needs; when
    it exceeds S the output undercounts and the caller must fall back to
    join_pairs_core. total is the emitted pair count."""
    Nl, Nr = lkeys.shape[0], rkeys.shape[0]
    M = Nl + Nr
    assert Nl < (1 << 30) and Nr < (1 << 30) and S >= 1
    left = how == JoinType.LEFT
    (k,), pidt_s = _merged_sort_tagged(lkeys, rkeys, keys32)
    is_b = (pidt_s & TAGBIT) == 0
    pid_s = (pidt_s & ~TAGBIT).to(torch.int32)
    pos = torch.arange(M, dtype=torch.int64, device=k.device)
    # run start position, forward-filled; builds sort first in-run, so a
    # probe at p needs distances up to p - rs
    rs = _fill_forward_max(torch.where(_run_starts(k), pos, 0))
    hb = is_b[rs]                     # does the run start with a build?
    matched = (~is_b) & hb
    maxneed = torch.where(matched, pos - rs, 0).max().to(torch.int32)

    lidx_ch, ridx_ch = [], []
    total = torch.zeros((), dtype=torch.int64, device=k.device)
    for s in range(1, S + 1):
        if s >= M:
            break
        valid = torch.zeros(M, dtype=torch.bool, device=k.device)
        valid[s:] = (k[s:] == k[:-s]) & is_b[:-s]
        valid &= ~is_b
        lidx_ch.append(torch.where(valid, pid_s, -2))
        pid_sh = torch.cat([pid_s.new_zeros(s), pid_s[:-s]])
        ridx_ch.append(torch.where(valid, pid_sh, -2))
        total = total + valid.sum(dtype=torch.int64)
    if left:
        miss = (~is_b) & (~hb)
        lidx_ch.append(torch.where(miss, pid_s, -2))
        ridx_ch.append(torch.where(miss, -1, -2).to(torch.int32))
        total = total + miss.sum(dtype=torch.int64)
    return torch.cat(lidx_ch), torch.cat(ridx_ch), total, maxneed


def join_pairs_core(lkeys, rkeys, cap: int, how: JoinType = JoinType.INNER,
                    keys32: bool = False):
    """Sort-probe join with duplicate expansion at a static cap, for any
    data: returns device arrays (lidx int32, ridx int32, total int64) of
    length Nr + Nl + Nr + cap with the valid pairs interspersed in
    build-rank order (-2 elsewhere, ridx -1 on LEFT misses). total is
    always the TRUE pair count, even when cap truncates.

      1. build sort (stable, key only)          -> rank -> build row
      2. _merged_bounds_inorder                 -> lo/hi per probe, in
                                                   merged key order
      3. expansion: merge of the offs entries and the cap slot entries
         (key (value << 1) | tag, payloads shifted one place so the
         nearest preceding offs entry carries the owner's values) and
         forward fills: slot -> (probe id, build rank j, miss)
      4. stable sort of the slots by rank
      5. merge of the build ranks with the slot ranks + forward fill:
         rank -> build row"""
    Nl, Nr = lkeys.shape[0], rkeys.shape[0]
    M = Nl + Nr
    assert (M + cap) < (1 << 31) and cap < (1 << 30) and Nr < (1 << 30)
    left = how == JoinType.LEFT
    dev = lkeys.device
    INVK = 0xFFFFFFFE                 # below the merge's pad key
    MISSBIT = 1 << 31

    bkey = (rkeys & 0xFFFFFFFF) if keys32 else (rkeys ^ _I64_MIN)
    order_s = torch.sort(bkey, stable=True).indices
    is_q, pid_m, lo_m, hi_m = _merged_bounds_inorder(lkeys, rkeys, keys32)
    counts = torch.where(is_q, hi_m - lo_m, 0)
    eff = torch.where(is_q, counts.clamp(min=1), counts) if left else counts
    offs = torch.cumsum(eff, 0, dtype=torch.int64)   # inclusive
    total = offs[-1]

    # --- expansion: slot t belongs to merged position i <=> offs[i-1] <=
    # t < offs[i] (a probe: builds have eff 0); the number of offs entries
    # sorting before slot t is exactly i
    tl = torch.arange(cap, dtype=torch.int64, device=dev)
    comp = torch.cat([offs << 1, (tl << 1) | 1])

    def shifted(x):
        return torch.cat([_u32(x[1:]),
                          torch.full((1 + cap,), SENT, dtype=torch.int64,
                                     device=dev)])

    ops = [comp, shifted(lo_m), shifted(pid_m)]
    if left:
        ops.append(shifted(counts))
    srt = merge_sorted_stable(M, *ops)
    c_s = srt[0]
    is_t = (c_s & 1) == 1
    pos = torch.arange(M + cap, dtype=torch.int64, device=dev)
    ic = pos + 1 - torch.cumsum(is_t, 0)              # owner position i
    prevv = _fill_forward_max(torch.where(is_t, 0, c_s >> 1))  # offs[i-1]
    lof = _fill_forward_last(srt[1], SENT)
    lof = torch.where(lof == SENT, _u32(lo_m[0]), lof)
    pidf = _fill_forward_last(srt[2], SENT)
    pidf = torch.where(pidf == SENT, _u32(pid_m[0]), pidf)
    k = (c_s >> 1) - prevv
    j = lof + k                                       # build RANK per slot
    slot_ok = is_t & (ic < M)                         # t < total
    if left:
        cntf = _fill_forward_last(srt[3], SENT)
        cntf = torch.where(cntf == SENT, _u32(counts[0]), cntf)
        miss = k >= cntf
        # a missing probe's single slot still needs a defined rank; rank
        # 0 always exists (Nr > 0 is guarded by join_pairs_device)
        j = torch.where(miss, 0, j)
        pidf = pidf | torch.where(miss, MISSBIT, 0)

    # --- slots to rank order (invalid entries -> INVK tail)
    key3 = torch.where(slot_ok, j, INVK)
    j_s, perm = torch.sort(key3, stable=True)
    pid_s3 = pidf[perm]

    # --- rank -> build row: merge of build entries (key rank << 1, row
    # payload) with slot entries (key (j << 1) | 1, probe-id payload),
    # both ascending, then a forward fill
    key_a = torch.arange(Nr, dtype=torch.int64, device=dev) << 1
    key_b = torch.where(j_s == INVK, INVK, (j_s << 1) | 1)
    pay_oid = torch.cat([order_s, torch.full((M + cap,), SENT,
                                             dtype=torch.int64, device=dev)])
    pay_pid = torch.cat([torch.full((Nr,), SENT, dtype=torch.int64,
                                    device=dev), pid_s3])
    km_s, oid_m, pid_f = merge_sorted_stable(
        Nr, torch.cat([key_a, key_b]), pay_oid, pay_pid)
    # build entries have even keys; INVK is even too, but its row payload
    # is SENT, so it never pollutes the fill
    even = (km_s & 1) == 0
    oid_f = _fill_forward_last(torch.where(even, oid_m, SENT), SENT)
    is_slot = (~even) & (pid_f != SENT)
    lidx = torch.where(is_slot, (pid_f & ~MISSBIT).to(torch.int32), -2)
    ridx = torch.where(is_slot, oid_f.to(torch.int32), -2)
    if left:
        ridx = torch.where(is_slot & ((pid_f & MISSBIT) != 0), -1, ridx)
    return lidx, ridx, total


def join_count_device(lkeys, rkeys, how: JoinType = JoinType.INNER):
    """Match-pair count: a 0-dim int64 device tensor (one scalar for the
    host to fetch)."""
    rs = torch.sort(rkeys ^ _I64_MIN).values ^ _I64_MIN
    lo, hi = _probe_bounds_merged(rs >> 32, rs, lkeys >> 32, lkeys)
    counts = (hi - lo).to(torch.int64)
    eff = counts.clamp(min=1) if how == JoinType.LEFT else counts
    return eff.sum()


def _check_keys(t, name: str):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 \
            or t.dim() != 1:
        raise TypeError(f"{name}: expected a 1-d int64 tensor of u64 key "
                        f"bits, got {getattr(t, 'dtype', type(t))}")


def join_pairs_device(lkeys, rkeys, how: JoinType = JoinType.INNER,
                      unique_build: bool = False, keys32: bool = False
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Device sort-probe join with duplicate expansion.

    lkeys/rkeys: 1-d int64 device tensors holding the u64 keys of a common
    join domain. Returns (lidx int64[M], ridx int64[M]) host arrays of the
    matched index pairs into the inputs, the reference's pairs in the
    reference's order; LEFT-join misses emit ridx == -1. The -2 entries
    are dropped on the device, so only the pairs cross to the host.

    The core ladder (each rung falls back to the next on a device-checked
    violation):
      unique_build=True -> join_pairs_core_unique (dup builds fall back)
      default           -> join_pairs_core_shift (runs spanning more than
                           SHIFT_S entries fall back)
      fallback          -> join_pairs_core, cap-retry: it returns the true
                           total even when cap truncates, so one retry at
                           the right cap covers any data

    keys32=True (both sides' keys < 2^32, as zone maps can prove) sorts
    on the low 32 bits only."""
    _check_keys(lkeys, "lkeys")
    _check_keys(rkeys, "rkeys")
    Nl, Nr = int(lkeys.shape[0]), int(rkeys.shape[0])
    empty = np.empty(0, np.int64)
    if Nl == 0:
        return empty, empty
    if Nr == 0:
        if how == JoinType.LEFT:
            return np.arange(Nl, dtype=np.int64), np.full(Nl, -1, np.int64)
        return empty, empty

    def filtered(lidx, ridx):
        keep = lidx != -2
        pairs = torch.stack([lidx[keep], ridx[keep]]).cpu().numpy()
        return pairs[0].astype(np.int64), pairs[1].astype(np.int64)

    if unique_build:
        lidx, ridx, total_d, dups_d = join_pairs_core_unique(
            lkeys, rkeys, how=how, keys32=keys32)
        if not bool(dups_d):
            if int(total_d) == 0:
                return empty, empty
            return filtered(lidx, ridx)
        # stale uniqueness hint: fall through

    lidx, ridx, total_d, maxneed_d = join_pairs_core_shift(
        lkeys, rkeys, S=SHIFT_S, how=how, keys32=keys32)
    if int(maxneed_d) <= SHIFT_S:
        if int(total_d) == 0:
            return empty, empty
        return filtered(lidx, ridx)

    cap = 1 << max(0, (Nl - 1).bit_length())
    while True:
        lidx, ridx, total_d = join_pairs_core(lkeys, rkeys, cap, how,
                                              keys32=keys32)
        total = int(total_d)
        if total <= cap:
            break
        cap = 1 << (total - 1).bit_length()
    if total == 0:
        return empty, empty
    return filtered(lidx, ridx)
