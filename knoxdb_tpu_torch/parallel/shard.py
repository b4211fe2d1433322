"""Pack-parallel scan over a Mesh (the port of knoxdb_tpu/parallel/shard.py).

A segment's packs are partitioned into contiguous pack ranges, one per
shard; the fused filter + sum kernel (#1, ops/scan_kernels.py) runs on
each shard's local packs (the scan has no cross-pack dependencies), and
only the per-pack partials cross to the host, where they add exactly.

Layout contract: per-pack arrays shard on their PACK axis. Planes are
plane-major u32[w, P, W] (pack axis 1), min_keys u64[P] and valid
u32[P, W] lead with it (axis 0). P must be a multiple of the shard count
(pack/segment.build_segment(uniform=N) pads with empty packs). A shard's
piece is a contiguous copy on its device: the kernels take contiguous
planes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import scan_kernels as SK
from ..ops import words as WD
from .mesh import Mesh, place

__all__ = ["make_mesh", "shard_packs", "sharded_range_scan",
           "sharded_scan_fn"]


def make_mesh(n_devices: int | None = None, axis: str = "packs",
              devices=None) -> Mesh:
    """A 1-d mesh of the first n CUDA devices of this process (all of
    them by default), or of `devices` when given (a virtual mesh may
    repeat a device). Raises when the process has fewer cards than asked
    for, or none: there is no fallback to the CPU."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = n_devices or have
        if have == 0 or n > have:
            raise RuntimeError(
                f"make_mesh: {n_devices or 'all'} CUDA devices asked for, "
                f"torch.cuda.device_count() is {have}; pass devices= for a "
                f"mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = list(devices)[:n_devices] if n_devices else list(devices)
    return Mesh(devices, (axis,))


def _tensor(x) -> torch.Tensor:
    """numpy (u32 words, u64 keys, bools, ints) or a tensor -> a tensor
    with the same bits (u32 as int32, u64 as int64)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a)


def _cut(x: torch.Tensor, axis: int, lo: int, hi: int, device):
    return place(x.narrow(axis, lo, hi - lo), device).contiguous()


def shard_packs(mesh: Mesh, tree, axis: str = "packs") -> list:
    """Every array of a (nested dict / list / tuple) tree cut into the
    mesh's pack ranges: one tree per shard, each piece a contiguous copy
    on the shard's device. 3-d arrays are plane-major planes [w, P, W]
    (pack axis 1); 1-/2-d arrays lead with the pack axis."""
    devs = mesh.flat()
    ndev = mesh.shape[axis]

    def npacks(t):
        if isinstance(t, dict):
            return npacks(next(iter(t.values())))
        if isinstance(t, (list, tuple)):
            return npacks(t[0])
        x = _tensor(t)
        return x.shape[1] if x.dim() == 3 else x.shape[0]

    P = npacks(tree)
    if P % ndev:
        raise ValueError(f"shard_packs: {P} packs on {ndev} shards; build "
                         f"the segment with uniform={ndev}")
    step = P // ndev

    def put(t, r):
        if isinstance(t, dict):
            return {k: put(v, r) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(put(v, r) for v in t)
        x = _tensor(t)
        return _cut(x, 1 if x.dim() == 3 else 0, r * step, (r + 1) * step,
                    devs[r])

    return [put(tree, r) for r in range(ndev)]


def _split_sum(pcnt, min_keys, cnt, width: int):
    """Exact (sum_lo, sum_hi) of one shard as python ints from kernel #1's
    per-plane popcounts: sum = sum_lo + 2^32 sum_hi, each plane p weighted
    2^p, plus each pack's min_key (lo and hi halves) times its count."""
    pc = pcnt.cpu().numpy().astype(object)
    c = cnt.cpu().numpy().astype(object)
    mk = min_keys.cpu().numpy().view(np.uint64).astype(object)
    lo = sum(int(pc[:, p].sum()) << p for p in range(min(width, 32)))
    hi = sum(int(pc[:, p].sum()) << (p - 32) for p in range(32, width))
    lo += int(((mk & 0xFFFFFFFF) * c).sum())
    hi += int(((mk >> 32) * c).sum())
    return lo, hi


def sharded_scan_fn(mesh: Mesh, width: int, axis: str = "packs"):
    """The multi-shard scan step: bitsliced RANGE filter + count / sum
    over pack-sharded operands (shard_packs of planes, min_keys, valid).
    Returns fn(planes, min_keys, valid, lo, hi) -> (count, sum_lo,
    sum_hi) as python ints. Every shard's kernel is launched before any
    result is read."""
    def fn(planes, min_keys, valid, lo, hi):
        # the per-pack operands are bound on the host first, so no read
        # sits between two shards' launches
        ops = [[WD.to_words(a, va.device) for a in SK.range_consts(
                    mk.cpu().numpy().view(np.uint64), np.uint64(lo),
                    np.uint64(hi), width)]
               for mk, va in zip(min_keys, valid)]
        outs = [SK.fused_range_sum_masked(pl, *op, va, width)
                for pl, op, va in zip(planes, ops, valid)]
        parts = [_split_sum(pcnt, mk, cnt, width)
                 for (_m, pcnt, cnt), mk in zip(outs, min_keys)]
        return (mesh.psum(cnt.sum(dtype=torch.int64) for _m, _p, cnt in outs),
                mesh.psum(p[0] for p in parts),
                mesh.psum(p[1] for p in parts))
    return fn


def sharded_range_scan(mesh: Mesh, planes, min_keys, valid, lo: int, hi: int,
                       width: int, axis: str = "packs"):
    """One-call helper: shard the inputs, run the multi-shard scan, return
    (count, exact_sum) as python ints."""
    fn = sharded_scan_fn(mesh, width, axis)
    sh = shard_packs(mesh, (planes, min_keys, valid), axis)
    cnt, s_lo, s_hi = fn([s[0] for s in sh], [s[1] for s in sh],
                         [s[2] for s in sh], lo, hi)
    return cnt, s_lo + (s_hi << 32)
