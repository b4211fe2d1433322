"""Mask -> selection-vector compaction and masked gathers.

The port of knoxdb_tpu/ops/compact.py. The contract stays: a selection
vector idx u32[cap] (int32-carried, ops/words.py) holds the (base + row)
positions of the set bits in ascending order, and SENTINEL 0xFFFFFFFF
past count; cap is the caller's static capacity.

The reference builds the vector with lax.top_k because a TPU scatter runs
far below bandwidth. Here it is an inclusive prefix sum of the mask and
one scatter at the static cap, with no host sync: each set row writes its
position to slot (prefix - 1); rows that are unset or past cap write into
a dump region after the cap, spread over 1024 slots so that no single
address takes every write, and the dump is cut off.
"""

from __future__ import annotations

import torch

from . import bitset as BS
from . import words as WD

__all__ = ["SENTINEL", "mask_to_indexes", "packed_mask_to_indexes",
           "take_rows", "compact_rows", "masked_row_ids", "first_k_indexes",
           "gather_plane_values"]

SENTINEL = -1           # 0xFFFFFFFF read as int32
_DUMP = 1024


def mask_to_indexes(mask: torch.Tensor, cap: int, base=0):
    """bool[N] (any shape, flattened) -> (idx int32[cap], count int64).

    idx[:count] are the (base + row) positions of set bits in ascending
    order, as u32 words (base + row wraps mod 2^32, as in the reference);
    idx[count:] == SENTINEL. count is a 0-dim device tensor."""
    mask = mask.reshape(-1)
    n = mask.shape[0]
    dev = mask.device
    cs = torch.cumsum(mask, 0, dtype=torch.int64)
    count = cs[-1] if n else torch.zeros((), dtype=torch.int64, device=dev)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    dump = cap + (rows & (_DUMP - 1))
    dest = torch.where(mask & (cs <= cap), cs - 1, dump)
    vals = WD.u32_from_i64((rows + base) & 0xFFFFFFFF)
    out = torch.full((cap + _DUMP,), SENTINEL, dtype=torch.int32, device=dev)
    out.scatter_(0, dest, vals)
    return out[:cap], count


def packed_mask_to_indexes(words: torch.Tensor, cap: int, base=0):
    """Packed int32[..., W] bitset -> selection vector (unpacks on the
    fly; rows run word-major over every leading dimension)."""
    return mask_to_indexes(BS.unpack_mask(words), cap, base)


def take_rows(limbs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of a limb column by selection vector.

    limbs: int32[L, N]; idx: int32[K] (sentinels allowed; they gather row
    0 -- callers slice by count). Returns int32[L, K]."""
    n = limbs.shape[-1]
    safe = torch.where(idx == SENTINEL, 0, idx).clamp(0, n - 1)
    return torch.index_select(limbs, -1, safe.long())


def compact_rows(limbs: torch.Tensor, mask: torch.Tensor, cap: int):
    """Fused filter-materialize: keep rows of `limbs` where mask is set.

    Returns (int32[L, cap], count). Rows past count are copies of row 0."""
    idx, count = mask_to_indexes(mask, cap)
    return take_rows(limbs, idx), count


def masked_row_ids(mask: torch.Tensor, rid_base: torch.Tensor):
    """bool[P, N] per-pack masks + u64[P] first rid per pack (int64 tensor
    holding the u64 bits) -> the global row id of every row, flattened
    pack-major, as u64 bits in int64; unset rows hold 0xFFFF...FFFF (-1)."""
    P, n = mask.shape
    flat = mask.reshape(-1)
    local = torch.arange(P * n, dtype=torch.int64, device=mask.device) % n
    base = torch.repeat_interleave(rid_base.to(torch.int64), n)
    return torch.where(flat, base + local, -1)


def first_k_indexes(mask_words: torch.Tensor, kcap: int):
    """Packed int32[P, W] mask -> (idx int32[kcap], count int64): the first
    kcap set rows in ascending order (idx past count = 0).

    One prefix sum over the mask and kcap binary searches: cheap at 16M+
    rows when k is small (the top-k path)."""
    flat = BS.unpack_mask(mask_words).reshape(-1)
    cs = torch.cumsum(flat, 0, dtype=torch.int32)
    count = cs[-1].to(torch.int64)
    targets = torch.arange(1, kcap + 1, dtype=torch.int32, device=flat.device)
    idx = torch.searchsorted(cs, targets).to(torch.int32)
    idx = torch.where(targets <= cs[-1], idx, 0)
    return idx, count


def gather_plane_values(planes: torch.Tensor, idx: torch.Tensor, N: int):
    """Bit-sliced int32[w, P, W] planes (plane-major) + flat row ids
    int32[K] -> tuple of int32-carried u32[K] value words, LSW first (any
    width, wide 128/256-bit included)."""
    w = planes.shape[0]
    idx = idx.long()
    pk = idx // N
    wd = (idx % N) // 32
    bit = (idx % 32)[:, None]
    words = planes[:, pk, wd].T                                 # [K, w]
    bits = ((words.to(torch.int64) >> bit) & 1)
    nw = -(-w // 32)
    bits = torch.nn.functional.pad(bits, (0, nw * 32 - w))
    weight = torch.tensor([1 << b for b in range(32)], dtype=torch.int64,
                          device=planes.device)
    out = (bits.reshape(-1, nw, 32) * weight).sum(-1)           # [K, nw]
    return tuple(WD.u32_from_i64(out[:, j]) for j in range(nw))
