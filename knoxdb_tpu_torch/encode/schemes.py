"""Compression containers: the host (numpy) encoders of
knoxdb_tpu/encode/schemes.py, with the same names and outputs.

- CONST    one value per pack
- RAW      keyform limbs as-is
- BITPACK  (v - min) stored as w bitplanes of N/32 u32 words each; bit k of
           word j of plane p is bit p of row j*32+k
- DELTA    zigzag(first differences) bitplane-packed
- RLE      run values + exclusive run ends
- DICT     codes bitplane-packed + sorted unique values
- ALP      floats as decimal-scaled ints (encode/alp.py), packed as BITPACK

Bit planes are packed by utils/native.bitplane_pack: the native C++
transpose where it builds, numpy else (the same words).

The device decodes run on int32-carried u32 words (ops/words.py), plane
widths 0-64 (a wide column's packs store 64-bit pack-relative keys). Torch
has no uint64: where the reference holds u64 keys the port holds int64
tensors with the same bits (`ops/words.bits_i64`), whose add, subtract and
cumsum wrap mod 2^64 as the u64 ones do.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import words as WD
from ..utils import native as NT


class Scheme(enum.IntEnum):
    CONST = 0
    RAW = 1
    BITPACK = 2
    DELTA = 3
    RLE = 4
    DICT = 5
    ALP = 6


@dataclass
class EncodedPack:
    """Host-side encoded form of one column pack (key domain)."""
    scheme: Scheme
    n: int                      # valid rows
    nlimbs: int                 # limbs of the logical type
    width: int = 0              # packed bit width (BITPACK/DELTA/DICT codes)
    min_key: int = 0            # subtracted base (BITPACK), base value (DELTA)
    planes: np.ndarray | None = None    # u32[width, N//32] bitplanes
    values: np.ndarray | None = None    # u32[L, k] CONST/RAW/RLE/DICT values
    ends: np.ndarray | None = None      # u32[k] RLE exclusive run ends
    k: int = 0                  # padded #values (RLE/DICT)
    card: int = 0               # true #values before padding (RLE/DICT)
    exp: int = 0                # ALP decimal exponent (v = enc / 10^exp)
    dict_keys: np.ndarray | None = None  # u64[card] sorted dict keys
    dict_bytes: list | None = None       # bytes dict for STRING/BYTES packs

    @property
    def nbytes(self) -> int:
        total = 0
        for a in (self.planes, self.values, self.ends):
            if a is not None:
                total += a.nbytes
        return total + 32


def _ceil_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _pack_bitplanes_np(vals: np.ndarray, width: int, n_pad: int) -> np.ndarray:
    """vals: u64[N] (< 2^width) -> u32[max(width, 1), n_pad//32]."""
    n = len(vals)
    out = np.zeros((max(width, 1), n_pad // 32), dtype=np.uint32)
    if width == 0:
        return out
    bits = np.zeros(n_pad, dtype=bool)
    for p in range(width):
        bits[:n] = (vals >> np.uint64(p)) & np.uint64(1)
        out[p] = np.packbits(bits.reshape(-1, 8), axis=-1,
                             bitorder="little").reshape(-1, 4).view(np.uint32).reshape(-1)
    return out


def _key_to_limbs(keys: np.ndarray, nlimbs: int) -> np.ndarray:
    """u64 keys -> u32[L, N] (L in {1, 2})."""
    if nlimbs == 1:
        return keys.astype(np.uint32)[None, :]
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.stack([hi, lo])


def _zigzag(d: np.ndarray) -> np.ndarray:
    di = d.view(np.int64)
    return ((di << 1) ^ (di >> 63)).view(np.uint64)


def encode_const(value_limbs: np.ndarray, n: int) -> EncodedPack:
    return EncodedPack(Scheme.CONST, n, value_limbs.shape[0],
                       values=np.asarray(value_limbs, np.uint32).reshape(-1, 1))


def encode_raw(limbs: np.ndarray, n: int, n_pad: int) -> EncodedPack:
    L = limbs.shape[0]
    out = np.zeros((L, n_pad), dtype=np.uint32)
    out[:, :n] = limbs
    return EncodedPack(Scheme.RAW, n, L, values=out)


def encode_bitpack(keys: np.ndarray, nlimbs: int, min_key: int, width: int,
                   n_pad: int) -> EncodedPack:
    shifted = keys - np.uint64(min_key)
    planes = NT.bitplane_pack(shifted, width, n_pad)
    return EncodedPack(Scheme.BITPACK, len(keys), nlimbs, width=width,
                       min_key=min_key, planes=planes)


def encode_delta(keys: np.ndarray, nlimbs: int, width: int, n_pad: int) -> EncodedPack:
    d = np.empty(len(keys), dtype=np.uint64)
    d[0] = 0
    d[1:] = keys[1:] - keys[:-1]
    zz = _zigzag(d)
    planes = NT.bitplane_pack(zz, width, n_pad)
    return EncodedPack(Scheme.DELTA, len(keys), nlimbs, width=width,
                       min_key=int(keys[0]), planes=planes)


def encode_rle(run_values_limbs: np.ndarray, run_ends: np.ndarray, n: int,
               nlimbs: int) -> EncodedPack:
    r = run_ends.shape[0]
    k = _ceil_pow2(max(r, 1))
    vals = np.zeros((nlimbs, k), dtype=np.uint32)
    vals[:, :r] = run_values_limbs
    ends = np.full(k, 0xFFFFFFFF, dtype=np.uint32)
    ends[:r] = run_ends
    return EncodedPack(Scheme.RLE, n, nlimbs, values=vals, ends=ends, k=k,
                       card=r)


def encode_string_dict(values: list, n_pad: int,
                       width_round=None) -> EncodedPack:
    """STRING/BYTES pack: sorted byte dictionary (host) + bitplane-packed
    codes (device). Every ordered predicate rewrites exactly into code
    space because the dictionary is byte-sorted and host-resident."""
    vals = [v.encode() if isinstance(v, str) else bytes(v) for v in values]
    uniq = sorted(set(vals))
    index = {b: i for i, b in enumerate(uniq)}
    codes = np.array([index[b] for b in vals], np.uint64)
    card = len(uniq)
    width = max(1, (card - 1).bit_length())
    if width_round:
        width = width_round(width)
    planes = NT.bitplane_pack(codes, width, n_pad)
    # prefix keys (8-byte big-endian) for zone maps / ordering hints
    pref = np.array([_prefix_key(b) for b in uniq], np.uint64)
    return EncodedPack(Scheme.DICT, len(vals), 2, width=width, planes=planes,
                       values=np.zeros((2, 1), np.uint32), k=_ceil_pow2(card),
                       card=card, dict_keys=pref, dict_bytes=uniq)


def encode_alp(vals: np.ndarray, n_pad: int, width_round=None
               ) -> EncodedPack | None:
    """FLOAT64 pack -> ALP ints bitplane-packed, or None (fallback)."""
    from . import alp as A
    got = A.try_alp(np.asarray(vals, np.float64))
    if got is None:
        return None
    enc, e = got
    mn = int(enc.min()) if len(enc) else 0
    rel64 = (enc - mn).astype(np.uint64)   # 0 <= rel < 2^52, no overflow
    width = int(rel64.max()).bit_length() if len(rel64) else 0
    if width_round:
        width = width_round(width)
    planes = NT.bitplane_pack(rel64, width, n_pad)
    return EncodedPack(Scheme.ALP, len(vals), 2, width=width, min_key=mn,
                       planes=planes, exp=e)


def _prefix_key(b: bytes) -> int:
    """First 8 bytes big-endian (stats cap strings at 8 bytes)."""
    p = b[:8].ljust(8, b"\x00")
    return int.from_bytes(p, "big")


def encode_dict(codes: np.ndarray, unique_limbs: np.ndarray, n: int,
                nlimbs: int, n_pad: int, width: int = 0,
                dict_keys: np.ndarray | None = None) -> EncodedPack:
    card = unique_limbs.shape[1]
    width = width or max(1, (card - 1).bit_length())
    planes = NT.bitplane_pack(codes.astype(np.uint64), width, n_pad)
    k = _ceil_pow2(card)
    vals = np.zeros((nlimbs, k), dtype=np.uint32)
    vals[:, :card] = unique_limbs
    # pad with the last value so padded codes (never produced) stay benign
    if card < k:
        vals[:, card:] = unique_limbs[:, -1:]
    return EncodedPack(Scheme.DICT, n, nlimbs, width=width, planes=planes,
                       values=vals, k=k, card=card, dict_keys=dict_keys)


# ---------------------------------------------------------------- decode ---
# Batched device decodes on int32-carried u32 words; inputs carry a pack
# axis P.

def _expand_bits(words: torch.Tensor) -> torch.Tensor:
    """int32[..., W] -> int32[..., W*32] of 0/1 (bit k of word w -> row
    w*32+k)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32)


_T32_MASKS = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)


def _bit_transpose32_pm(x: torch.Tensor) -> torch.Tensor:
    """int32[32, ..., W] -> int32[32, ..., W]: Hacker's Delight transpose32
    of each 32x32 bit block whose 32 words lie on the leading axis (W
    vectorizes); 5 masked exchange passes of whole-array ops."""
    j = 16
    for m in _T32_MASKS:
        sh = x.shape
        xr = x.reshape(32 // (2 * j), 2, j, *sh[1:])
        a = xr[:, 0]
        b = xr[:, 1]
        t = (a ^ WD.lsr(b, j)) & m
        x = torch.stack([a ^ t, b ^ (t << j)], dim=1).reshape(sh)
        j //= 2
    return x


def decode_bitplanes_pair(planes: torch.Tensor, width: int):
    """int32[max(w,1), P, N32] plane-major -> (lo int32[P, N], hi int32[P,
    N]), the packed-domain value halves, by 32x32 bit-matrix transpose:
    plane word b of rows 32k..32k+31 is row b of a bit matrix whose
    transpose's row i is the value word of row 32k+i. Widths 0-64. The
    pair is also the port's form of the reference's decode_bitplanes_u64:
    torch has no uint64 to bitcast the halves into."""
    if not 0 <= width <= 64:
        raise ValueError(f"decode_bitplanes_pair: width {width} outside "
                         f"[0, 64]")
    _w, P, n32 = planes.shape

    def tr(block):
        # transpose32 is the anti-transpose (T[i] bit b = M[31-b] bit
        # 31-i); flipping the 32 axis on both sides straightens it
        k = 32 - block.shape[0]
        if k:
            block = torch.cat([block, block.new_zeros((k, P, n32))])
        t = _bit_transpose32_pm(block.flip(0)).flip(0)
        return t.permute(1, 2, 0).reshape(P, n32 * 32)

    lo = tr(planes[:min(width, 32)])
    if width > 32:
        hi = tr(planes[32:width])
    else:
        hi = planes.new_zeros((P, n32 * 32))
    return lo, hi


def decode_bitplanes_u32(planes: torch.Tensor, width: int) -> torch.Tensor:
    """Packed-domain values of width <= 32 as int32-carried u32 [P, N].
    Small widths keep the expand/or chain (padding to a 32-plane
    transpose costs more than the short chain); wider ones transpose."""
    if width > 32:
        raise ValueError(f"decode_bitplanes_u32: width {width} > 32")
    if width > 8:
        return decode_bitplanes_pair(planes, width)[0]
    _w, P, n32 = planes.shape
    out = planes.new_zeros((P, n32 * 32))
    for p in range(width):
        out = out | (_expand_bits(planes[p]) << p)
    return out


def decode_bitplanes_u64(planes: torch.Tensor, width: int) -> torch.Tensor:
    """int32[max(w,1), P, N32] -> int64[P, N] holding the packed-domain u64
    bits (ops/words.bits_i64). Narrow widths (a sequential key's DELTA
    planes) keep decode_bitplanes_u32's short chain: the 32-plane transpose
    costs 2.1 ms at [256, 65,536] on an H100 whatever the width."""
    if width <= 8:
        return WD.u32_to_i64(decode_bitplanes_u32(planes, width))
    return WD.bits_i64(*decode_bitplanes_pair(planes, width))


def key_u64_to_limbs(keys: torch.Tensor, nlimbs: int) -> torch.Tensor:
    """int64 u64 bits [P, N] -> int32-carried limbs [L, P, N], L in {1, 2},
    most significant first."""
    lo, hi = WD.halves_of_bits(keys)
    return lo[None] if nlimbs == 1 else torch.stack([hi, lo])


def decode_const(values: torch.Tensor, P: int, N: int) -> torch.Tensor:
    """values int32[P, L, 1] -> int32[L, P, N] broadcast (a view)."""
    return values.permute(1, 0, 2).expand(values.shape[1], P, N)


def decode_raw(values: torch.Tensor) -> torch.Tensor:
    """values int32[P, L, N] -> int32[L, P, N] (a view)."""
    return values.permute(1, 0, 2)


def decode_bitpack(planes, min_keys, width: int, nlimbs: int):
    """planes int32[max(w,1), P, N32], min_keys int64 u64 bits [P] ->
    int32[L, P, N]."""
    if width <= 32 and nlimbs == 1:
        v = decode_bitplanes_u32(planes, width) \
            + WD.halves_of_bits(min_keys)[0][:, None]
        return v[None]
    v = decode_bitplanes_u64(planes, width) + min_keys[:, None]
    return key_u64_to_limbs(v, nlimbs)


def decode_delta(planes, base_keys, width: int, nlimbs: int):
    """Zigzag deltas -> wrapping cumsum + base. planes int32[max(w,1), P,
    N32], base int64 u64 bits [P] -> int32[L, P, N]."""
    zz = decode_bitplanes_u64(planes, width)
    d = WD.lsr64(zz, 1) ^ (-(zz & 1))
    v = torch.cumsum(d, dim=-1) + base_keys[:, None]
    return key_u64_to_limbs(v, nlimbs)


def rle_run_index(ends: torch.Tensor, N: int) -> torch.Tensor:
    """ends int32-carried u32[P, k] -> int32[P, N] run index per row
    (run[i] = #ends <= i)."""
    row = torch.arange(N, dtype=torch.int64, device=ends.device)
    return (WD.u32_to_i64(ends)[:, :, None] <= row).sum(dim=1,
                                                        dtype=torch.int32)


def _gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values int32[P, L, k], idx [P, N] -> int32[L, P, N]."""
    P, L, _k = values.shape
    g = torch.gather(values, 2, idx.long()[:, None, :].expand(P, L, -1))
    return g.permute(1, 0, 2)


def decode_rle(values, ends, N: int):
    """values int32[P, L, k], ends u32[P, k] -> int32[L, P, N]."""
    return _gather_rows(values, rle_run_index(ends, N))


def decode_dict(planes, values, width: int):
    """Code planes int32[max(w,1), P, N32], values int32[P, L, k] ->
    int32[L, P, N]."""
    return _gather_rows(values, decode_bitplanes_u32(planes, width))


def dict_gather_mask(code_planes, width: int, dict_mask):
    """The dictionary matcher: the predicate evaluated on the dictionary
    (k values), gathered by code. dict_mask bool[P, k] -> bool[P, N]."""
    codes = decode_bitplanes_u32(code_planes, width).long()
    return torch.gather(dict_mask, 1, codes)


def rle_gather_mask(ends, run_mask, N: int):
    """The RLE matcher: a predicate on run values expanded to rows."""
    return torch.gather(run_mask, 1, rle_run_index(ends, N).long())
