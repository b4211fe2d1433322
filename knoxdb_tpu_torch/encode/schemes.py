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

The device reads the planes as they are (exec/device.py); the device
decodes of the reference wait for a later slice (ROADMAP.md queue 1
item 2).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np


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
    planes = _pack_bitplanes_np(shifted, width, n_pad)
    return EncodedPack(Scheme.BITPACK, len(keys), nlimbs, width=width,
                       min_key=min_key, planes=planes)


def encode_delta(keys: np.ndarray, nlimbs: int, width: int, n_pad: int) -> EncodedPack:
    d = np.empty(len(keys), dtype=np.uint64)
    d[0] = 0
    d[1:] = keys[1:] - keys[:-1]
    zz = _zigzag(d)
    planes = _pack_bitplanes_np(zz, width, n_pad)
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
    planes = _pack_bitplanes_np(codes, width, n_pad)
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
    planes = _pack_bitplanes_np(rel64, width, n_pad)
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
    planes = _pack_bitplanes_np(codes.astype(np.uint64), width, n_pad)
    k = _ceil_pow2(card)
    vals = np.zeros((nlimbs, k), dtype=np.uint32)
    vals[:, :card] = unique_limbs
    # pad with the last value so padded codes (never produced) stay benign
    if card < k:
        vals[:, card:] = unique_limbs[:, -1:]
    return EncodedPack(Scheme.DICT, n, nlimbs, width=width, planes=planes,
                       values=vals, k=k, card=card, dict_keys=dict_keys)
