"""Order-by / top-k over device segments.

The port of knoxdb_tpu/exec/sort.py. Ordering happens in the KEYFORM
domain (utils/limbs.py), where every type (signed, unsigned, decimal,
wide) is an unsigned lexicographic integer, so one family serves all
types. Two routes:

- the bit descent (`_topk_fast_plan` + `_topk_bit_descent`), when every
  pack of the order column is BITPACK: the packs' planes are rebased to
  one comparable domain (ops/bitslice.add_const_planes), an MSB-first
  radix select finds the k-th key's threshold (ops/bitslice.topk_select),
  and only 2·kcap candidate rows are gathered; nothing sorts the rows;
- the fallback for any other scheme mix: narrow keys take one stable sort
  of the order-preserving int64 keys; wide keys take LSB-first stable
  sorts over 64-bit limb pairs. Filtered-out rows carry a sentinel key
  that sinks to the end. The reference calls lax.top_k, which returns the
  lower row first among equal keys; torch.topk promises no tie order, so
  the port sorts stably instead.

Per-segment top-k results merge on the host (k is small).
"""

from __future__ import annotations

import numpy as np
import torch

from ..encode.schemes import Scheme
from ..ops import bitset as BS
from ..ops import bitslice as B
from ..ops import compact as CP
from ..ops import words as WD
from . import device as D

__all__ = ["segment_topk"]

_SENT = (1 << 63) - 1       # u64 max in the order-preserving int64 form
_MAX_PLANES = 272           # widest rebased key the descent takes


def _flat_keys_u64(scanner, fname: str) -> torch.Tensor:
    """Decode a narrow column to flat order-preserving int64 keys [P*N]
    (value domain). A float column with ALP packs orders by the float
    keyform of its decoded values: an ALP pack's own keys are relative to
    its pack's base and exponent and do not compare across packs (the
    reference sorts those, ROADMAP.md section 3)."""
    if any(g.scheme == Scheme.ALP for g in scanner.d.column(fname).groups):
        return scanner._decode_fkey(
            fname, scanner._decode_f64(fname)).reshape(-1)
    return scanner._decode_rows(fname, D.group_decode_keys).reshape(-1)


def _flat_limbs(scanner, fname: str) -> torch.Tensor:
    """Absolute keyform limbs int32[L, P*N] (wide BITPACK packs rebased on
    the device)."""
    dec = scanner._decode_rows(
        fname, lambda g, W: tuple(D.group_decode_limbs_abs(g, W)))
    return torch.stack(dec).reshape(len(dec), -1)


def segment_topk(scanner, tree, order_field: str, k: int,
                 desc: bool = False, project: list[str] | None = None,
                 exclude_words=None):
    """Top-k rows of one segment under a filter.

    Returns (order_keys, rows, n): order_keys are python-int keyform keys
    (the host merges segments with these), rows maps each projected field
    to a u32 limb matrix [L, n] and "__idx" to the row positions, and n is
    the number of rows returned, at most k."""
    d = scanner.d
    project = project or []
    col = d.seg.columns[order_field]
    wide = col.wide
    used = sorted(set([order_field] + project))

    mask_fn, margs = scanner.prepare(tree, [], exclude_words)

    # the plan depends on the segment alone: cache it per field (segments
    # are immutable, scanner._fns dies with the segment)
    fp_key = ("topk-fastplan", order_field)
    if fp_key in scanner._fns:
        fast = scanner._fns[fp_key]
    else:
        fast = _topk_fast_plan(d, col, order_field)
        scanner._fns[fp_key] = fast
    if fast is not None:
        return _topk_bit_descent(scanner, margs, mask_fn, fast, order_field,
                                 k, desc, project, exclude_words is not None)

    sig = ("topk", d.sig(used), order_field, k, desc, wide, tuple(project),
           exclude_words is not None, scanner._plan_sigs[id(mask_fn)])
    fn = scanner._fns.get(sig)
    if fn is None:

        def fn(margs):
            mask, _, _ = mask_fn(*margs)
            flat_mask = BS.unpack_mask(mask).reshape(-1)
            if wide:
                absl = _flat_limbs(scanner, order_field)
                limbs = ~absl if desc else absl
                limbs = torch.where(flat_mask[None], limbs, WD.FULL)
                L = limbs.shape[0]
                # radix over 64-bit limb pairs, least significant pair
                # first, each pass stable
                order = torch.arange(limbs.shape[1], device=limbs.device)
                for c in range((L + 1) // 2 - 1, -1, -1):
                    lo = limbs[2 * c + 1] if 2 * c + 1 < L \
                        else torch.zeros_like(limbs[2 * c])
                    chunk = WD.ordered_i64(lo, limbs[2 * c])
                    order = order[torch.sort(chunk[order],
                                             stable=True).indices]
                top = order[:k]
                okeys = absl[:, top]
            else:
                keys = _flat_keys_u64(scanner, order_field)
                skeys = torch.where(flat_mask, ~keys if desc else keys,
                                    _SENT)
                # the k smallest keys ascending, the lower row first among
                # equal keys
                top = torch.sort(skeys, stable=True).indices[:k]
                okeys = keys[top]
            outs = {"__idx": top}
            for name in project:
                outs[name] = _flat_limbs(scanner, name)[:, top]
            return outs, okeys, flat_mask[top]

        scanner._fns[sig] = fn

    outs, okeys, valid = fn(margs)
    nvalid = int(valid.sum())
    kk = min(k, nvalid)
    if wide:                       # vectorized object-int assembly
        ok = WD.from_words(okeys)
        keys_a = ok[0, :kk].astype(object)
        for l in range(1, ok.shape[0]):
            keys_a = (keys_a << 32) + ok[l, :kk].astype(object)
    else:
        keys_a = WD.u64_from_ordered(okeys.cpu().numpy())[:kk].astype(object)
    rows = {"__idx": outs["__idx"].cpu().numpy()[:nvalid]}
    for name in project:
        rows[name] = WD.from_words(outs[name])[..., :nvalid]
    return keys_a.tolist(), rows, nvalid


def _topk_fast_plan(d, col, order_field: str):
    """Bit-descent eligibility: every pack of the order column BITPACK,
    narrow or wide (the descent works at any width). Returns (width_out,
    const_bits u32[wo, P] numpy, gmin): bit b of each pack's (base - gmin)
    as a full / zero word, from python ints on the host; None when the
    column does not qualify."""
    dcol = d.column(order_field)
    if any(g.scheme != Scheme.BITPACK for g in dcol.groups):
        return None
    if sum(g.npacks for g in dcol.groups) != d.P:
        return None
    if col.wide and any(g.bases is None for g in dcol.groups):
        return None
    # per-PACK minimum bases in pack order (the groups partition the packs;
    # widths may differ per group: add_const_planes zero-extends)
    mins = [0] * d.P
    wmax = 0
    for g in dcol.groups:
        wmax = max(wmax, g.width)
        for j, pi in enumerate(g.idx):
            mins[int(pi)] = int(g.bases[j]) if col.wide \
                else int(g.min_keys[j])
    gmin = min(mins)
    rel_max = max(m - gmin for m in mins) + (1 << wmax) - 1
    wo = max(1, rel_max.bit_length())
    if wo > _MAX_PLANES:
        return None
    nbytes = -(-wo // 8)
    bits = np.stack([np.unpackbits(np.frombuffer(
        (m - gmin).to_bytes(nbytes, "little"), np.uint8),
        bitorder="little")[:wo] for m in mins], axis=1)          # [wo, P]
    cb = np.where(bits != 0, np.uint32(0xFFFFFFFF), np.uint32(0))
    return wo, cb, gmin


def _abs_planes(scanner, d, order_field: str, cb_np, lo: int, hi: int,
                wo: int):
    """The order column's planes over packs [lo, hi) of the device
    segment d, rebased to width wo by the packs' constant bits
    cb_np[:, lo:hi] (uploaded once per scanner)."""
    key = ("topk-cb", order_field, lo)
    cb = scanner._fns.get(key)
    if cb is None:
        cb = WD.to_words(cb_np[:, lo:hi], d.device)
        scanner._fns[key] = cb
    groups = d.column(order_field).groups
    if len(groups) == 1:
        return B.add_const_planes(groups[0].arrays["planes"], cb, wo)
    # the groups partition the packs: rebase each group's planes to width
    # wo, scatter into pack order
    absp = torch.zeros((wo, d.P, d.W), dtype=torch.int32, device=d.device)
    for g in groups:
        absp[:, g.idx_t] = B.add_const_planes(g.arrays["planes"],
                                              cb[:, g.idx_t], wo)
    return absp


def _topk_bit_descent(scanner, margs, mask_fn, fast, order_field: str,
                      k: int, desc: bool, project: list[str],
                      has_excl: bool):
    """Top-k by an MSB-first radix SELECT over comparable bitplanes
    (ops/bitslice.topk_select) instead of a sort of the row population:
    width / 2 popcount steps and gathers of 2·kcap rows. One host sync per
    call, at the fetch of one packed buffer."""
    d = scanner.d
    wo, cb_np, gmin = fast
    kcap = max(1, 1 << (k - 1).bit_length())
    used = sorted(set([order_field] + project))
    sig = ("topk-bd", d.sig(used), order_field, kcap, desc, tuple(project),
           has_excl, scanner._plan_sigs[id(mask_fn)])
    fn = scanner._fns.get(sig)
    nw = -(-wo // 32)
    proj_limbs = [d.seg.columns[nm].nlimbs for nm in project]
    if fn is None:

        def fn(margs, kk: int):
            mask, _, _ = mask_fn(*margs)
            absp = scanner._over_packs(
                lambda dd, lo, hi: _abs_planes(scanner, dd, order_field,
                                               cb_np, lo, hi, wo), dim=1)
            _tw, better, tie, nb = B.topk_select(absp, mask, kk, wo,
                                                 want_max=desc)
            bi, _bc = CP.first_k_indexes(better, kcap)
            ti, tc = CP.first_k_indexes(tie, kcap)
            idx = torch.cat([bi, ti])
            vwords = CP.gather_plane_values(absp, idx, d.N)
            ar = torch.arange(kcap, dtype=torch.int64, device=d.device)
            # tie picks are bounded by BOTH the remaining quota and the
            # actual tie population (fewer matches than k)
            sel = torch.cat([ar < nb, (ar < (kk - nb)) & (ar < tc)])
            # ONE packed int32 buffer, ONE host fetch, the call's only sync
            parts = [sel.to(torch.int32), idx, *vwords]
            for name in project:
                parts.append(_flat_limbs(scanner, name)[:, idx.long()]
                             .reshape(-1))
            return torch.cat(parts)

        scanner._fns[sig] = fn

    buf = WD.from_words(fn(margs, k))
    K2 = 2 * kcap
    sel = buf[:K2] != 0
    idx_np = buf[K2:2 * K2].astype(np.int64)
    vw = [buf[(2 + j) * K2:(3 + j) * K2] for j in range(nw)]
    off = (2 + nw) * K2
    outs = {"__idx": idx_np}
    for name, L in zip(project, proj_limbs):
        outs[name] = buf[off:off + L * K2].reshape(L, K2)
        off += L * K2
    pick = np.flatnonzero(sel)
    # vectorized object-int key assembly (no per-row python at any k)
    keys_a = np.full(len(pick), gmin, object)
    for j, w in enumerate(vw):
        keys_a = keys_a + (w[pick].astype(object) << (32 * j))
    order = np.argsort(keys_a, kind="stable")
    if desc:
        order = order[::-1]
    pick = pick[order]
    rows = {name: (a[..., pick] if a.ndim > 1 else a[pick])
            for name, a in outs.items()}
    return keys_a[order].tolist(), rows, len(pick)
