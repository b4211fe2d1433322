"""Random operands for the fused scan kernels, made on the host from a
numpy Generator, so that one case can feed the CUDA kernel, its plain
PyTorch version and the knoxdb_tpu reference alike."""

from __future__ import annotations

import numpy as np

from ..ops import scan_kernels as SK

__all__ = ["random_tree_case", "misaligned_copy", "split_layouts",
           "split_masks"]


def _rand_u32(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _leaf_consts(rng, width: int, P: int):
    """range_consts of a random range on random per-pack min_keys: most
    packs overlap the range, some lie wholly inside, below or above it
    (the degenerate-pack flags), and some bounds sit at 0 or 2^64-1."""
    span = 1 << min(width, 62)
    base = int(rng.integers(1 << 40, 1 << 41))
    mk = base + rng.integers(0, max(span // 4, 1), P).astype(object)
    far = rng.random(P) < 0.15
    mk[far] = mk[far] + (1 << 62) * rng.integers(-1, 2, int(far.sum()))
    b = [base + int(rng.random() * 1.25 * span) for _ in range(2)]
    r = rng.random()
    if r < 0.1:
        b[0] = 0
    elif r < 0.2:
        b[1] = (1 << 64) - 1
    lo, hi = min(b), max(b)
    if rng.random() < 0.05:
        lo, hi = hi, lo                       # an empty range
    return SK.range_consts(np.array([max(int(x), 0) for x in mk], np.uint64),
                           np.uint64(lo), np.uint64(hi), width)


def random_tree_case(rng, fwidths, P: int, W: int, nleaf: int,
                     agg_specs, empty_pack: bool = True):
    """Operands of fused_tree_agg as numpy u32 arrays.

    fwidths: per-field plane widths; leaf j filters field j % nfield with
    a random range on random per-pack min_keys. Returns (planes_list
    [u32[max(w,1), P, W]], leaf_ops [(lo_bits, hi_bits, flags)],
    leaf_field, mask_in u32[P, W], fwidths, agg_specs). With empty_pack,
    the last pack's incoming mask is all zero."""
    planes_list = []
    for w in fwidths:
        pl = _rand_u32(rng, (max(w, 1), P, W))
        if w == 0:
            pl[:] = 0
        planes_list.append(pl)
    leaf_ops, leaf_field = [], []
    for j in range(nleaf):
        f = j % len(fwidths)
        leaf_ops.append(_leaf_consts(rng, fwidths[f], P))
        leaf_field.append(f)
    mask_in = _rand_u32(rng, (P, W)) | _rand_u32(rng, (P, W))
    if empty_pack:
        mask_in[-1] = 0
    return (planes_list, leaf_ops, tuple(leaf_field), mask_in,
            tuple(fwidths), tuple(agg_specs))


def misaligned_copy(t):
    """A contiguous copy of the int32 tensor t whose data starts one word
    (4 bytes) past a 16-byte boundary."""
    import torch
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def split_layouts(planes):
    """The planes int32[w1, P, W] in the four layouts the split scan kernels
    take: plane-major, the permuted view of a pack-major [P, w1, W] tensor,
    a misaligned copy, and a view of [w1, P, W + 1] (pack stride W + 1).
    The last two run the kernels' scalar form, the first two their 16-byte
    form where W % 4 == 0."""
    import torch
    w1, P, W = planes.shape
    odd = torch.empty((w1, P, W + 1), dtype=planes.dtype,
                      device=planes.device)[..., :W]
    odd.copy_(planes)
    return {"plane-major": planes,
            "pack-major": planes.permute(1, 0, 2).contiguous()
            .permute(1, 0, 2),
            "misaligned": misaligned_copy(planes),
            "odd pack stride": odd}


def split_masks(rng, P: int, W: int):
    """Incoming masks u32[P, W] for the split scan kernels, by name: absent
    (None), empty, full, random, and rows only in each pack's last word."""
    last = np.zeros((P, W), np.uint32)
    last[:, -1] = _rand_u32(rng, P) | 1
    return {"absent": None, "empty": np.zeros((P, W), np.uint32),
            "full": np.full((P, W), 0xFFFFFFFF, np.uint32),
            "random": _rand_u32(rng, (P, W)), "last word": last}
