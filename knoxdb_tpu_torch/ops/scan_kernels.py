"""Fused bit-sliced scan: range filter + aggregate partials in one pass.

The port of knoxdb_tpu/ops/pallas_scan.py. Two wrappers, each with its
plain PyTorch version beside it:

- `fused_range_sum_masked` (alias `fused_range_sum`): one column's range
  ladder AND an incoming mask -> (mask, per-plane masked popcounts,
  count). Replaces the TPU kernel `_kernel_masked`.
- `fused_tree_agg` (thin wrapper `fused_tree_sum`): every fused AND leaf's
  ladder over deduplicated per-field planes AND mask_in, then per agg
  spec the masked per-plane popcounts and/or the min/max tournament.
  Replaces the TPU kernel `_kernel_tree`.

On a CUDA tensor a wrapper launches its hand-written kernel
(csrc/scan_kernels.cu) or raises; on a CPU tensor it runs the plain
version. Words are int32-carried u32 (ops/words.py). `LAUNCHES` counts
kernel launches and `PLAIN_CALLS` plain-version runs taken by a wrapper.

Per-pack range constants arrive as per-plane select words (0 / ~0) plus
degenerate-pack flag words, built on the host from u64 min_keys by
`range_consts` (u64 never reaches the device).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..types import FilterMode
from . import bitslice as B

__all__ = ["range_consts", "fused_range_sum_masked", "fused_range_sum",
           "fused_tree_agg", "fused_tree_sum", "fused_range_sum_ref",
           "fused_range_sum_masked_torch", "fused_tree_agg_torch",
           "LAUNCHES", "PLAIN_CALLS", "reset_counts", "MAX_FIELDS",
           "MAX_LEAVES", "MAX_SPECS", "MAX_WIDTH"]

# kernel capacities (csrc/scan_kernels.cu KNOX_MAX_*)
MAX_FIELDS = 8
MAX_LEAVES = 8
MAX_SPECS = 8
MAX_WIDTH = 64

# flag word columns (u32 0 / ~0 per pack)
_F_LO_LT_ALL = 0    # lo above the pack domain
_F_LO_GE_NONE = 1   # lo at/below the pack domain base
_F_HI_IN = 2        # hi representable in the pack domain (eq contributes)
_F_HI_GE_NONE = 3   # hi below the pack domain  -> le_hi = none
_F_HI_LT_ALL = 4    # hi above the pack domain  -> le_hi = all
_NFLAGS = 8
_MM_COLS = 8        # mnmx columns: mn_lo, mn_hi, mx_lo, mx_hi, 4 zeros

LAUNCHES = {"fused_range_sum_masked": 0, "fused_tree_agg": 0}
PLAIN_CALLS = {"fused_range_sum_masked": 0, "fused_tree_agg": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def range_consts(min_keys, lo, hi, width: int):
    """Per-pack kernel constants for lo <= x <= hi (value domain), on the
    host. lo/hi are u64 scalars or per-pack arrays. Returns numpy
    (lo_bits u32[P, max(w,1)], hi_bits u32[P, max(w,1)], flags u32[P, 8])."""
    lo_rel, lo_lt_all, lo_ge_none, _lo_in = B._rel_const(lo, min_keys, width)
    hi_rel, hi_lt_all, hi_ge_none, hi_in = B._rel_const(hi, min_keys, width)
    flags = np.zeros((lo_rel.shape[0], _NFLAGS), np.uint32)
    for col, b in ((_F_LO_LT_ALL, lo_lt_all), (_F_LO_GE_NONE, lo_ge_none),
                   (_F_HI_IN, hi_in), (_F_HI_GE_NONE, hi_ge_none),
                   (_F_HI_LT_ALL, hi_lt_all)):
        flags[:, col] = np.where(b, np.uint32(0xFFFFFFFF), np.uint32(0))
    return B.const_bits(lo_rel, width), B.const_bits(hi_rel, width), flags


# ---------------------------------------------------------- plain versions --

def _ladder_torch(planes, lo_bits, hi_bits, flags, width: int):
    """The kernel's range ladder: bitslice.range_planes_rel with the
    per-pack relations read back from the flag words."""
    f = flags != 0
    return B.range_planes_rel(
        planes, (lo_bits, f[:, _F_LO_LT_ALL], f[:, _F_LO_GE_NONE], None),
        (hi_bits, f[:, _F_HI_LT_ALL], f[:, _F_HI_GE_NONE], f[:, _F_HI_IN]),
        width)


def _pcnt_torch(planes, mask, width: int):
    return B.masked_sum_planes(planes, mask, width)[0].to(torch.int32)


def _minmax_torch(planes, mask, width: int):
    mn = B._tournament_planes(planes, mask, width, want_max=False)
    mx = B._tournament_planes(planes, mask, width, want_max=True)
    out = torch.zeros((mask.shape[0], _MM_COLS), dtype=torch.int32,
                      device=mask.device)
    for c, v in enumerate((*mn, *mx)):
        out[:, c] = v
    return out


def fused_range_sum_masked_torch(planes, lo_bits, hi_bits, flags, mask_in,
                                 width: int):
    """Plain PyTorch version of fused_range_sum_masked."""
    mask = _ladder_torch(planes, lo_bits, hi_bits, flags, width) & mask_in
    cnt = B.popcount_words(mask).to(torch.int32)
    return mask, _pcnt_torch(planes, mask, width), cnt


def fused_tree_agg_torch(planes_list, leaf_ops, leaf_field, mask_in,
                         fwidths, agg_specs):
    """Plain PyTorch version of fused_tree_agg."""
    m = mask_in
    for (lo_b, hi_b, fl), f in zip(leaf_ops, leaf_field):
        m = m & _ladder_torch(planes_list[f], lo_b, hi_b, fl, fwidths[f])
    cnt = B.popcount_words(m).to(torch.int32)
    parts = []
    for slot, want_sum, want_mm in agg_specs:
        d = {}
        if want_sum:
            d["pcnt"] = _pcnt_torch(planes_list[slot], m, fwidths[slot])
        if want_mm:
            d["mnmx"] = _minmax_torch(planes_list[slot], m, fwidths[slot])
        parts.append(d)
    return m, cnt, parts


# ---------------------------------------------------------------- wrappers --

def _check(t, name: str, shape, device):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError(f"{name}: expected an int32 tensor, got "
                        f"{getattr(t, 'dtype', type(t))}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_width(width: int):
    if not 0 <= width <= MAX_WIDTH:
        raise ValueError(f"width {width} outside [0, {MAX_WIDTH}]")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")


def fused_range_sum_masked(planes, lo_bits, hi_bits, flags, mask_in,
                           width: int):
    """planes int32[max(w,1), P, W] plane-major; lo_bits/hi_bits
    int32[P, max(w,1)] and flags int32[P, 8] from range_consts; mask_in
    int32[P, W]. Returns (mask int32[P, W], pcnt int32[P, max(w,1)],
    cnt int32[P])."""
    _check_width(width)
    P, W = mask_in.shape
    w1 = max(width, 1)
    dev = mask_in.device
    for t, name, shape in ((planes, "planes", (w1, P, W)),
                           (lo_bits, "lo_bits", (P, w1)),
                           (hi_bits, "hi_bits", (P, w1)),
                           (flags, "flags", (P, _NFLAGS)),
                           (mask_in, "mask_in", (P, W))):
        _check(t, name, shape, dev)
    if dev.type == "cpu":
        PLAIN_CALLS["fused_range_sum_masked"] += 1
        return fused_range_sum_masked_torch(planes, lo_bits, hi_bits, flags,
                                            mask_in, width)
    if dev.type != "cuda":
        raise ValueError(f"fused_range_sum_masked: unsupported device {dev}")
    from .cuda_build import load
    lib = load()
    mask = torch.empty((P, W), dtype=torch.int32, device=dev)
    pcnt = torch.empty((P, w1), dtype=torch.int32, device=dev)
    cnt = torch.empty((P,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knox_fused_range_sum_masked(
            planes.data_ptr(), width, lo_bits.data_ptr(), hi_bits.data_ptr(),
            flags.data_ptr(), mask_in.data_ptr(), mask.data_ptr(),
            pcnt.data_ptr(), cnt.data_ptr(), P, W, stream)
    _raise_on(err, "fused_range_sum_masked")
    LAUNCHES["fused_range_sum_masked"] += 1
    return mask, pcnt, cnt


# validity plays exactly the incoming-mask role: one kernel, two names
fused_range_sum = fused_range_sum_masked


def _ptrs(ts):
    return (ctypes.c_void_p * max(len(ts), 1))(
        *[t.data_ptr() if t is not None else None for t in ts])


def _ints(xs):
    return (ctypes.c_int * max(len(xs), 1))(*xs)


def fused_tree_agg(planes_list, leaf_ops, leaf_field, mask_in, fwidths,
                   agg_specs):
    """Whole-AND-tree scan + every fused aggregate partial in one pass.

    planes_list: per-FIELD planes int32[max(w_f,1), P, W] (deduplicated);
    leaf_ops: per-LEAF (lo_bits, hi_bits, flags) from range_consts;
    leaf_field: per-leaf field slot; fwidths: per-field widths;
    agg_specs: (field_slot, want_sum, want_mm) per aggregate — want_sum
    emits pcnt int32[P, max(w_f,1)], want_mm mnmx int32[P, 8]
    (mn_lo, mn_hi, mx_lo, mx_hi pack-relative, then 4 zero columns).
    Empty agg_specs is a mask-only plan.

    Returns (mask int32[P, W], cnt int32[P], parts: one dict per spec)."""
    fwidths = tuple(int(w) for w in fwidths)
    leaf_field = tuple(int(f) for f in leaf_field)
    agg_specs = tuple((int(s), bool(a), bool(b)) for s, a, b in agg_specs)
    nf, nl, ns = len(planes_list), len(leaf_ops), len(agg_specs)
    if nf > MAX_FIELDS or nl > MAX_LEAVES or ns > MAX_SPECS:
        raise ValueError(f"fused_tree_agg: {nf} fields / {nl} leaves / "
                         f"{ns} specs exceed {MAX_FIELDS}/{MAX_LEAVES}/"
                         f"{MAX_SPECS}")
    if len(fwidths) != nf or len(leaf_field) != nl:
        raise ValueError("fused_tree_agg: fwidths/leaf_field lengths")
    if any(not 0 <= f < nf for f in leaf_field) or \
            any(not 0 <= s < nf for s, _a, _b in agg_specs):
        raise ValueError("fused_tree_agg: field slot out of range")
    P, W = mask_in.shape
    dev = mask_in.device
    _check(mask_in, "mask_in", (P, W), dev)
    for f, (pl, w) in enumerate(zip(planes_list, fwidths)):
        _check_width(w)
        _check(pl, f"planes[{f}]", (max(w, 1), P, W), dev)
    for j, ((lo_b, hi_b, fl), f) in enumerate(zip(leaf_ops, leaf_field)):
        w1 = max(fwidths[f], 1)
        _check(lo_b, f"lo_bits[{j}]", (P, w1), dev)
        _check(hi_b, f"hi_bits[{j}]", (P, w1), dev)
        _check(fl, f"flags[{j}]", (P, _NFLAGS), dev)
    if dev.type == "cpu":
        PLAIN_CALLS["fused_tree_agg"] += 1
        return fused_tree_agg_torch(planes_list, leaf_ops, leaf_field,
                                    mask_in, fwidths, agg_specs)
    if dev.type != "cuda":
        raise ValueError(f"fused_tree_agg: unsupported device {dev}")
    from .cuda_build import load
    lib = load()
    mask = torch.empty((P, W), dtype=torch.int32, device=dev)
    cnt = torch.empty((P,), dtype=torch.int32, device=dev)
    parts, pcnts, mnmxs = [], [], []
    for slot, want_sum, want_mm in agg_specs:
        d = {}
        if want_sum:
            d["pcnt"] = torch.empty((P, max(fwidths[slot], 1)),
                                    dtype=torch.int32, device=dev)
        if want_mm:
            d["mnmx"] = torch.empty((P, _MM_COLS), dtype=torch.int32,
                                    device=dev)
        pcnts.append(d.get("pcnt"))
        mnmxs.append(d.get("mnmx"))
        parts.append(d)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knox_fused_tree_agg(
            _ptrs(planes_list), _ints(fwidths), nf,
            _ptrs([o[0] for o in leaf_ops]), _ptrs([o[1] for o in leaf_ops]),
            _ptrs([o[2] for o in leaf_ops]), _ints(leaf_field), nl,
            _ints([s for s, _a, _b in agg_specs]), _ptrs(pcnts),
            _ptrs(mnmxs), ns, mask_in.data_ptr(), mask.data_ptr(),
            cnt.data_ptr(), P, W, stream)
    _raise_on(err, "fused_tree_agg")
    LAUNCHES["fused_tree_agg"] += 1
    return mask, cnt, parts


def fused_tree_sum(planes_list, leaf_ops, leaf_field, mask_in, fwidths,
                   agg_slot: int):
    """Sum-only / mask-only wrapper over fused_tree_agg; agg_slot -1 is
    mask-only. Returns (mask, pcnt int32[P, max(w_agg, 1)], cnt)."""
    specs = ((agg_slot, True, False),) if agg_slot >= 0 else ()
    mask, cnt, parts = fused_tree_agg(planes_list, leaf_ops, leaf_field,
                                      mask_in, fwidths, specs)
    if specs:
        return mask, parts[0]["pcnt"], cnt
    return mask, torch.zeros((mask_in.shape[0], 1), dtype=torch.int32,
                             device=mask_in.device), cnt


def fused_range_sum_ref(planes, min_keys, valid, lo, hi, width: int):
    """Reference composition from the bitslice ops (same outputs as
    fused_range_sum) for oracle testing; min_keys u64[P] on the host."""
    mask = B.match_planes(FilterMode.RANGE, planes, min_keys, width,
                          lo=lo, hi=hi) & valid
    pcnt, cnt = B.masked_sum_planes(planes, mask, width)
    return mask, pcnt.to(torch.int32), cnt.to(torch.int32)
