"""Per-column bitonic sort of (u32 key, u32 payload) tiles.

The port of the sort probe's Pallas kernel (probes/msort_probe.py: `call`
:138, `kern_sort` :127, `exchange` :102): the measurement of whether a
hand-written bitonic sort could beat the library sort on the join's merged
(key, tagged id) operands. The join itself sorts with torch.sort, as the
reference sorts with jax.lax.sort.

Keys and payloads are int32-carried u32[N] (ops/words.py), N a multiple of
TILE = 512 x 128: B tiles of [R, C] rows x columns. Every column's 512
pairs go through the probe's 45-stage network (STAGES), compared
unsigned, then each tile through `ntpose` transpose-and-reshapes of
[R, C]. The result is that network's exactly, tied payloads included; it
is a sorted column only because the network sorts.

`tile_bitonic_sort` launches the CUDA kernel of csrc/sort_kernels.cu on
CUDA tensors (or raises) and runs the plain PyTorch version
`tile_bitonic_sort_torch` on CPU tensors. `LAUNCHES` counts kernel
launches and `PLAIN_CALLS` plain-version runs taken by the wrapper. The
kernel sorts a column in one warp's registers, lane l holding rows
16l .. 16l + 15 (tests/test_torch_sort_kernels.py models its schedule
and its store order in numpy).
"""

from __future__ import annotations

import torch

__all__ = ["R", "C", "TILE", "STAGES", "tile_bitonic_sort",
           "tile_bitonic_sort_torch", "LAUNCHES", "PLAIN_CALLS",
           "reset_counts"]

R, C = 512, 128
TILE = R * C
_I32_MIN = -(1 << 31)

LAUNCHES = {"tile_bitonic_sort": 0}
PLAIN_CALLS = {"tile_bitonic_sort": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _stages() -> list[tuple[int, int]]:
    """(k, d) for k = 2, 4, ..., R and d = k/2, ..., 1: 45 stages at R = 512
    (the probe's col_sort_stages)."""
    out = []
    k = 2
    while k <= R:
        d = k // 2
        while d >= 1:
            out.append((k, d))
            d //= 2
        k *= 2
    return out


STAGES = _stages()


def _exchange(kv, pv, k: int, d: int):
    """One compare-exchange stage on [B, R, C] tiles at row distance d,
    direction alternating every k rows (the probe's `exchange`). kv holds
    the keys with the sign bit flipped, so the signed compare is the
    unsigned one."""
    B = kv.shape[0]
    g = R // (2 * d)
    k4 = kv.reshape(B, g, 2 * d, C)
    p4 = pv.reshape(B, g, 2 * d, C)
    a_k, b_k = k4[:, :, :d], k4[:, :, d:]
    a_p, b_p = p4[:, :, :d], p4[:, :, d:]
    row = (torch.arange(g, device=kv.device)[:, None] * (2 * d)
           + torch.arange(d, device=kv.device)[None, :])
    asc = (((row // k) % 2) == 0)[None, :, :, None]
    swap = torch.where(asc, a_k > b_k, a_k < b_k)
    kv = torch.cat([torch.where(swap, b_k, a_k),
                    torch.where(swap, a_k, b_k)], dim=2).reshape(B, R, C)
    pv = torch.cat([torch.where(swap, b_p, a_p),
                    torch.where(swap, a_p, b_p)], dim=2).reshape(B, R, C)
    return kv, pv


def tile_bitonic_sort_torch(keys: torch.Tensor, pay: torch.Tensor,
                            ntpose: int = 0):
    """Plain PyTorch version of tile_bitonic_sort."""
    _check(keys, pay, ntpose)
    B = keys.shape[0] // TILE
    kv = (keys ^ _I32_MIN).reshape(B, R, C)
    pv = pay.reshape(B, R, C)
    for k, d in STAGES:
        kv, pv = _exchange(kv, pv, k, d)
    for _ in range(ntpose):
        kv = kv.transpose(1, 2).reshape(B, R, C)
        pv = pv.transpose(1, 2).reshape(B, R, C)
    return (kv ^ _I32_MIN).reshape(-1), pv.reshape(-1)


def _check(keys, pay, ntpose: int) -> None:
    for name, t in (("keys", keys), ("pay", pay)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"tile_bitonic_sort {name}: expected an int32 "
                            f"tensor, got {getattr(t, 'dtype', type(t))}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"tile_bitonic_sort {name}: must be 1-d and "
                             f"contiguous")
    if keys.shape != pay.shape or keys.device != pay.device:
        raise ValueError("tile_bitonic_sort: keys and pay differ in shape "
                         "or device")
    if keys.shape[0] % TILE:
        raise ValueError(f"tile_bitonic_sort: N = {keys.shape[0]} is not a "
                         f"multiple of {TILE}")
    if ntpose < 0:
        raise ValueError(f"tile_bitonic_sort: ntpose = {ntpose}")


def tile_bitonic_sort(keys: torch.Tensor, pay: torch.Tensor,
                      ntpose: int = 0):
    """(keys, pay) int32-carried u32[N] -> the network's (keys, pay), each
    int32[N]: every 512-row column of every [512, 128] tile sorted by
    unsigned key, then ntpose transpose-and-reshapes per tile."""
    _check(keys, pay, ntpose)
    dev = keys.device
    if dev.type == "cpu":
        PLAIN_CALLS["tile_bitonic_sort"] += 1
        return tile_bitonic_sort_torch(keys, pay, ntpose)
    if dev.type != "cuda":
        raise ValueError(f"tile_bitonic_sort: unsupported device {dev}")
    ko, po = torch.empty_like(keys), torch.empty_like(pay)
    if keys.shape[0] == 0:
        return ko, po
    # the kernel moves 16-byte vectors: a view at another offset is copied
    keys, pay = (t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (keys, pay))
    from .cuda_build import load
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knox_tile_bitonic_sort(keys.data_ptr(), pay.data_ptr(),
                                         ko.data_ptr(), po.data_ptr(),
                                         keys.shape[0], ntpose, stream)
    if err != 0:
        raise RuntimeError(f"tile_bitonic_sort: CUDA launch failed with "
                           f"cudaError_t {err}")
    LAUNCHES["tile_bitonic_sort"] += 1
    return ko, po
