"""Distributed hash join: a salted all-to-all shuffle over a Mesh, then
the single-device join cores per shard, returning MATCHED ROW PAIRS (the
port of knoxdb_tpu/parallel/shuffle.py).

Both sides are hash-partitioned by key over the mesh (`_bucket`), tiles
of [ndev, cap] rows are exchanged (Mesh.all_to_all), and every shard
joins what it received with exec/join's cores: the unique-build core, the
shift core, or the general core with its count pass. Positions ride the
exchange, so the pairs are GLOBAL row indices of the inputs.

Skew handling (salted repartition): per-(shard, bucket) histograms come
first; buckets holding more than skew_factor x the mean are HEAVY. Probe
rows of heavy buckets spread round-robin over every shard (the salt) and
build rows of heavy buckets replicate to every shard, so one hot key
cannot overload one shard. Tile caps come from the histograms and cannot
overflow: a shard's rows into one tile never exceed what the cap counts.

The core ladder is decided over the whole mesh, as the reference decides
it: unique while no shard holds a repeated valid build key; else shift
while no shard's key run spans more than SHIFT_S entries; else general,
at one pair cap (the next power of two of the busiest shard's pair
count). The cores sort with torch.sort (kernel #8 stays off the join, as
on one card).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..exec import join as J
from ..types import JoinType
from .mesh import Mesh, place

__all__ = ["shuffle_join_rows", "shuffle_join", "SKEW_FACTOR", "SHIFT_S"]

SKEW_FACTOR = 4.0      # bucket is heavy above this multiple of the mean
SHIFT_S = J.SHIFT_S    # shift-core span
_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) carried in int64, c < 2^32,
    by 16-bit halves of c: no product reaches 2^63."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _bucket(keys: torch.Tensor, ndev: int) -> torch.Tensor:
    """Bucket id of u64 keys (int64 bits): the reference's u32 mix of the
    key's halves, lo ^ (hi * 0x85EBCA6B) and two murmur steps, then mod
    ndev, bit for bit. Torch has no uint32 multiply or shift on the CPU,
    so every u32 value rides int64, masked to 32 bits after each step."""
    lo = keys & _M32
    hi = (keys >> 32) & _M32
    h = lo ^ _mul32(hi, 0x85EBCA6B)
    h = _mul32(h ^ (h >> 16), 0xC2B2AE35)
    h = h ^ (h >> 13)
    return h % ndev


def _bucketize(keys, pos, dest, ndev: int, cap: int, replicate: bool):
    """Rows sorted stably by dest, sliced into tiles [ndev, cap]: tile j
    holds the rows of dest j and, where replicate, then every row of dest
    ndev (heavy build rows); dest ndev + 1 (invalid rows) drops. Returns
    (keys, positions, ok) [ndev, cap]."""
    n = keys.shape[0]
    dev = keys.device
    ds, order = torch.sort(dest, stable=True)
    ks, ps = keys[order], pos[order]
    bounds = torch.searchsorted(ds, torch.arange(ndev + 2, device=dev))
    start = bounds[:ndev, None]
    cnt = (bounds[1:ndev + 1] - bounds[:ndev])[:, None]
    j = torch.arange(cap, device=dev)[None, :]
    in_norm = j < cnt
    if replicate:
        h_cnt = bounds[ndev + 1] - bounds[ndev]
        idx = torch.where(in_norm, start + j, bounds[ndev] + (j - cnt))
        ok = in_norm | ((j >= cnt) & (j < cnt + h_cnt))
    else:
        idx = start + j
        ok = in_norm
    idx = idx.clamp(0, max(n - 1, 0))
    return ks[idx], ps[idx], ok


def _salted_tiles(lk, lv, rk, rv, heavy, r: int, ndev: int, cap_l: int,
                  cap_r: int):
    """One source shard's exchange tiles. Heavy-bucket probe rows spread
    round-robin over the running count of heavy rows, offset by the shard
    index; heavy build rows replicate (dest ndev); invalid rows drop (dest
    ndev + 1)."""
    dev = lk.device
    n_l, n_r = lk.shape[0], rk.shape[0]
    lpos = torch.arange(n_l, device=dev) + r * n_l
    rpos = torch.arange(n_r, device=dev) + r * n_r
    bl = _bucket(lk, ndev)
    br = _bucket(rk, ndev)
    hv = place(heavy, dev)
    is_hl = hv[bl] & lv
    spread = (torch.cumsum(is_hl.to(torch.int64), 0) - 1 + r) % ndev
    dl = torch.where(lv, torch.where(is_hl, spread, bl), ndev + 1)
    dr = torch.where(rv, torch.where(hv[br], ndev, br), ndev + 1)
    return (_bucketize(lk, lpos, dl, ndev, cap_l, False)
            + _bucketize(rk, rpos, dr, ndev, cap_r, True))


def _pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def _quant(x: int) -> int:
    """Round up to 4 significant bits: tile-cap slack <= 6.7%."""
    x = max(1, int(x))
    if x <= 16:
        return x
    step = 1 << (x.bit_length() - 4)
    return -(-x // step) * step


def _sharded_keys(mesh: Mesh, keys, n_pad: int):
    """Keys (u64 numpy or an int64 tensor of u64 bits) padded to n_pad
    and cut into one contiguous range per shard: (keys, valid) lists."""
    if isinstance(keys, torch.Tensor):
        src = keys.to(torch.int64)
    else:
        src = torch.from_numpy(np.ascontiguousarray(keys, np.uint64)
                               .view(np.int64))
    n = src.shape[0]
    full = torch.zeros(n_pad, dtype=torch.int64, device=src.device)
    full[:n] = src
    valid = torch.zeros(n_pad, dtype=torch.bool, device=src.device)
    valid[:n] = True
    devs = mesh.flat()
    step = n_pad // len(devs)
    return ([place(full[r * step:(r + 1) * step], d)
             for r, d in enumerate(devs)],
            [place(valid[r * step:(r + 1) * step], d)
             for r, d in enumerate(devs)])


def _filter_pairs(lidx, ridx, lp, rp):
    """A core's interspersed pairs (-2 where a slot holds none) -> global
    (lpos, rpos), rpos -1 on LEFT misses."""
    keep = lidx != -2
    li, ri = lidx[keep].long(), ridx[keep].long()
    return lp[li], torch.where(ri < 0, -1, rp[ri.clamp(min=0)])


def _trivial_pairs(lp, rk, how: JoinType):
    """The pairs of a shard that has no probe row or no build row."""
    if lp.shape[0] and rk.shape[0] == 0 and how == JoinType.LEFT:
        return lp, torch.full_like(lp, -1)
    return lp[:0], lp[:0]


def shuffle_join_rows(mesh: Mesh, lkeys, rkeys, how: str = "inner",
                      axis: str = "shards",
                      skew_factor: float = SKEW_FACTOR,
                      unique_build: bool = False,
                      keys32: bool = False):
    """Distributed equi-join returning matched GLOBAL ROW PAIRS.

    lkeys / rkeys: u64 numpy arrays or int64 tensors of u64 key bits; row
    i is global index i. Returns (lidx i64[M], ridx i64[M], stats) as
    numpy. LEFT misses emit ridx == -1. Skew never raises: heavy buckets
    salt the probe side and replicate the build side.

    keys32=True (both sides' keys proven < 2^32) sorts on the low 32 bits
    in every core."""
    ndev = mesh.shape[axis]
    jhow = JoinType.LEFT if how == "left" else JoinType.INNER
    nl, nr = len(lkeys), len(rkeys)
    pad_l = -(-max(nl, 1) // ndev) * ndev
    pad_r = -(-max(nr, 1) // ndev) * ndev
    lk_s, lv_s = _sharded_keys(mesh, lkeys, pad_l)
    rk_s, rv_s = _sharded_keys(mesh, rkeys, pad_r)

    t0 = time.perf_counter()
    # phase 1: per-(source shard, bucket) row histograms [ndev, ndev]
    def hist(k, v):
        d = torch.where(v, _bucket(k, ndev), ndev)
        return torch.bincount(d, minlength=ndev + 1)[:ndev]

    hl_d = [hist(k, v) for k, v in zip(lk_s, lv_s)]
    hr_d = [hist(k, v) for k, v in zip(rk_s, rv_s)]
    hl2 = np.stack([h.cpu().numpy() for h in hl_d]).astype(np.int64)
    hr2 = np.stack([h.cpu().numpy() for h in hr_d]).astype(np.int64)
    hl, hr = hl2.sum(axis=0), hr2.sum(axis=0)
    mean = max((hl.sum() + hr.sum()) / ndev, 1.0)
    heavy = (hl + hr) > skew_factor * mean

    # tight tile caps: a probe tile holds its bucket's non-heavy rows and a
    # round-robin share of the shard's heavy rows; a build tile its
    # bucket's non-heavy rows and every heavy row of the shard
    nh_l = np.where(heavy[None, :], 0, hl2)
    nh_r = np.where(heavy[None, :], 0, hr2)
    hv_l = hl2[:, heavy].sum(axis=1) if heavy.any() \
        else np.zeros(ndev, np.int64)
    hv_r = hr2[:, heavy].sum(axis=1) if heavy.any() \
        else np.zeros(ndev, np.int64)
    cap_l = _quant((nh_l.max(axis=1) + -(-hv_l // ndev)).max())
    cap_r = _quant((nh_r.max(axis=1) + hv_r).max())
    cap_l = min(cap_l, _pow2(pad_l // ndev))
    cap_r = min(cap_r, _pow2(pad_r // ndev))

    # phase 2: the salted exchange
    heavy_t = torch.from_numpy(heavy)
    tiles = [_salted_tiles(lk, lv, rk, rv, heavy_t, r, ndev, cap_l, cap_r)
             for r, (lk, lv, rk, rv) in enumerate(zip(lk_s, lv_s, rk_s,
                                                      rv_s))]
    recv = [[t.reshape(-1) for t in mesh.all_to_all([s[i] for s in tiles])]
            for i in range(6)]
    parts = []
    for lkx, lpx, lox, rkx, rpx, rox in zip(*recv):
        parts.append((lkx[lox], lpx[lox], rkx[rox], rpx[rox]))
    rows_dev = [int(lox.sum()) + int(rox.sum())
                for lox, rox in zip(recv[2], recv[5])]

    # the core ladder, decided over every shard
    live = [bool(lk.shape[0]) and bool(rk.shape[0])
            for lk, _lp, rk, _rp in parts]
    core, cap_m, outs = None, 0, None
    if unique_build:
        outs = [J.join_pairs_core_unique(lk, rk, jhow, keys32) if ok
                else None for (lk, _lp, rk, _rp), ok in zip(parts, live)]
        if not any(bool(o[3]) for o in outs if o is not None):
            core = "unique"
    if core is None:
        outs = [J.join_pairs_core_shift(lk, rk, SHIFT_S, jhow, keys32)
                if ok else None
                for (lk, _lp, rk, _rp), ok in zip(parts, live)]
        if max((int(o[3]) for o in outs if o is not None),
               default=0) <= SHIFT_S:
            core = "shift"
    if core is None:
        core = "general"
        nmatch = [J.join_count_device(lk, rk, jhow) if ok
                  else (lk.shape[0] if jhow == JoinType.LEFT else 0)
                  for (lk, _lp, rk, _rp), ok in zip(parts, live)]
        cap_m = _pow2(max(max(int(m) for m in nmatch), 1))
        outs = [J.join_pairs_core(lk, rk, cap_m, jhow, keys32) if ok
                else None for (lk, _lp, rk, _rp), ok in zip(parts, live)]
    pairs = [_filter_pairs(o[0], o[1], lp, rp) if o is not None
             else _trivial_pairs(lp, rk, jhow)
             for o, (_lk, lp, rk, rp) in zip(outs, parts)]
    lidx = torch.cat([p[0].cpu() for p in pairs]).numpy()
    ridx = torch.cat([p[1].cpu() for p in pairs]).numpy()
    t1 = time.perf_counter()

    # 17 B per EXCHANGED SLOT (key + position + validity), cap slack
    # included: the all-to-all volume
    bytes_moved = ndev * ndev * (cap_l + cap_r) * (8 + 8 + 1)
    # a shard's local join takes ndev * (cap_l + cap_r) slots against the
    # ideal (pad_l + pad_r) / ndev rows
    work_eff = ((pad_l + pad_r) / ndev) / (ndev * (cap_l + cap_r))
    stats = {"ndev": ndev, "heavy_buckets": int(heavy.sum()),
             "cap_exchange": (cap_l, cap_r), "cap_pairs": cap_m,
             "core": core, "work_eff": work_eff,
             "seconds": t1 - t0, "shuffle_bytes": bytes_moved,
             "shuffle_gbps": bytes_moved / max(t1 - t0, 1e-9) / 1e9,
             "rows_per_dev": rows_dev,
             "work_eff_measured": float(((nl + nr) / ndev)
                                        / max(max(rows_dev), 1))}
    return lidx.astype(np.int64), ridx.astype(np.int64), stats


def shuffle_join(mesh: Mesh, lkeys: np.ndarray, lvals: np.ndarray,
                 rkeys: np.ndarray, rvals: np.ndarray,
                 skew_factor: float = SKEW_FACTOR, axis: str = "shards"):
    """(matches, checksum) with checksum = the sum of lval + rval over the
    matches (mod 2^64), on the rows path."""
    lidx, ridx, _ = shuffle_join_rows(mesh, lkeys, rkeys, how="inner",
                                      axis=axis, skew_factor=skew_factor)
    if not len(lidx):
        return 0, 0
    lv = np.asarray(lvals, np.uint64)[lidx]
    rv = np.asarray(rvals, np.uint64)[ridx]
    csum = int((lv.astype(object) + rv.astype(object)).sum() % (1 << 64))
    return len(lidx), csum
