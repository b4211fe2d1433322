"""Per-group exact count and sums: the group-by and moments kernels.

The port of knoxdb_tpu/ops/pallas_group.py. Two wrappers, each with its
plain PyTorch version beside it:

- `fused_group_partials`: per group, the count and the sums of one u32
  value pair (lo, hi). Replaces the TPU kernel `_kernel`.
- `fused_group_moments_partials`: the same with two value pairs, the
  value (rlo, rhi) and its square (qlo, qhi), in one pass. Replaces the
  TPU kernel `_kernel_moments`.

Both launch the hand-written CUDA kernel of csrc/group_kernels.cu on a
CUDA tensor (or raise), and run the plain version on a CPU tensor.
`LAUNCHES` counts kernel launches and `PLAIN_CALLS` plain-version runs
taken by a wrapper. `group_tile_plan` gives the kernel's form, chosen by
G (32-bit shared counters, or u64 atomics in L2 past what fits), and its
launch geometry.

The contract changed from the TPU kernels' and is the callers' own. The
TPU kernels emit f32[B, H, L*(C+1)] per-tile sums of the values' byte
chunks, one-hot matmul outputs that are exact only while every entry stays
below 2^24, which the tile size guarantees; the caller adds the tiles in
u64 and `exec/groupby.mxu_chunk_sums` recombines the bytes. What every
caller uses is the exact per-group count and sum, which is what the sort
path `group_aggregate` states directly: (counts, sum_lo, sum_hi) with
sum = sum_lo + sum_hi * 2^32. So these kernels keep exact 64-bit integer
sums of the u32 halves: each is below n * 2^32 < 2^63 for n < 2^31 rows,
which the wrappers check, and integer additions in any order give the same
bits. Both forms give the same python-int sums
(tests/test_torch_group_kernels.py holds them against each other).

Inputs: gid int32[P, N]; mask_words int32[P, N/32], the packed row mask
(bit k of word w is row w*32+k); value words int32-carried u32 [P, N]
(ops/words.py). Rows masked out or with gid outside [0, G) contribute
nothing. Outputs: int64[G] tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import bitset as BS
from . import words as WD

__all__ = ["fused_group_partials", "fused_group_moments_partials",
           "fused_group_partials_torch",
           "fused_group_moments_partials_torch", "LAUNCHES", "PLAIN_CALLS",
           "reset_counts", "MAX_ROWS", "GroupPlan", "group_tile_plan",
           "max_shared_groups"]

MAX_ROWS = 1 << 31      # exclusive: the sums stay below 2^63 under it

# csrc/group_kernels.cu. LIMBS: rows per ring stage, threads per block
# (one producer warp, eight consumer warps), the most chunks between two
# flushes, the largest limb, the shared memory of a block and of an SM,
# the ring's share of it, its most stages and blocks per SM. GLOBAL:
# threads per block, rows per thread and blocks per SM.
CHUNK_ROWS = 1024
BLOCK_THREADS = 288
LIMB_CHUNKS = 64
LIMB_MAX = (1 << 16) - 1
SMEM_BLOCK = 232448
SMEM_SM = 233472
RING_BYTES = 65536
MAX_STAGES = 4
BLOCKS_PER_SM = 2
GLOBAL_THREADS = 256
GLOBAL_UNROLL = 4
GLOBAL_BLOCKS_PER_SM = 4
MODES = {"global": 0, "limbs": 1}

LAUNCHES = {"fused_group_partials": 0, "fused_group_moments_partials": 0}
PLAIN_CALLS = {"fused_group_partials": 0, "fused_group_moments_partials": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ------------------------------------------------------- launch geometry --

@dataclass(frozen=True)
class GroupPlan:
    """Launch geometry of knox_group_sums. mode: "limbs" (32-bit
    shared-memory counters fed by a TMA ring of `stages` chunks) or
    "global" (u64 atomics in L2, when the histogram does not fit);
    tile_rows: the most rows a block adds into its counters between two
    flushes (0 for "global")."""
    mode: str
    stages: int
    blocks: int
    smem: int
    hist_bytes: int
    tile_rows: int


def stage_bytes(K: int) -> int:
    """One ring stage: a chunk's gid and 2K value words, and its mask."""
    return CHUNK_ROWS * 4 * (1 + 2 * K) + CHUNK_ROWS // 8


def _ring(K: int) -> tuple[int, int]:
    """(stages, bytes) of the LIMBS ring, its mbarriers included."""
    sb = stage_bytes(K)
    stages = max(2, min(MAX_STAGES, RING_BYTES // sb))
    return stages, stages * (sb + 16)


def max_shared_groups(K: int) -> int:
    """The largest G whose 32-bit counters fit beside the ring in a block's
    shared memory: the switch from "limbs" to "global"."""
    return (SMEM_BLOCK - _ring(K)[1]) // (4 * (1 + 4 * K))


def group_tile_plan(n: int, G: int, K: int, sms: int = 132) -> GroupPlan:
    """The group kernel's form and geometry for n rows (a multiple of 32),
    G groups and K value pairs on a card with `sms` SMs. "limbs" takes
    4(1 + 4K) bytes of counters per group beside the ring, and up to
    BLOCKS_PER_SM blocks per SM where they fit; G past max_shared_groups(K)
    runs "global" at up to GLOBAL_BLOCKS_PER_SM blocks per SM."""
    if G > max_shared_groups(K):
        blocks = min(-(-n // (GLOBAL_THREADS * GLOBAL_UNROLL)),
                     sms * GLOBAL_BLOCKS_PER_SM)
        return GroupPlan("global", 0, max(1, blocks), 0, 0, 0)
    stages, ring = _ring(K)
    hist = 4 * (1 + 4 * K) * G
    smem = ring + hist
    per_sm = max(1, min(BLOCKS_PER_SM, SMEM_SM // (smem + 1024)))
    blocks = min(-(-n // CHUNK_ROWS), sms * per_sm)
    return GroupPlan("limbs", stages, max(1, blocks), smem, hist,
                     min(LIMB_CHUNKS * CHUNK_ROWS, n))


# ---------------------------------------------------------- plain versions --

def _group_sums_torch(gid, mask_words, vals, G: int):
    ok = BS.unpack_mask(mask_words) & (gid >= 0) & (gid < G)
    idx = gid[ok].long()
    out = [torch.zeros(G, dtype=torch.int64, device=gid.device)
           .index_add_(0, idx, torch.ones_like(idx))]
    for v in vals:
        out.append(torch.zeros(G, dtype=torch.int64, device=gid.device)
                   .index_add_(0, idx, WD.u32_to_i64(v[ok])))
    return tuple(out)


def fused_group_partials_torch(gid, mask_words, vlo, vhi, G: int):
    """Plain PyTorch version of fused_group_partials."""
    return _group_sums_torch(gid, mask_words, (vlo, vhi), G)


def fused_group_moments_partials_torch(gid, mask_words, rlo, rhi, qlo, qhi,
                                       G: int):
    """Plain PyTorch version of fused_group_moments_partials."""
    return _group_sums_torch(gid, mask_words, (rlo, rhi, qlo, qhi), G)


# ---------------------------------------------------------------- wrappers --

def _check(t, name: str, shape, device):
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError(f"{name}: expected an int32 tensor, got "
                        f"{getattr(t, 'dtype', type(t))}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _group_sums(name: str, gid, mask_words, vals, G: int):
    if not isinstance(gid, torch.Tensor) or gid.dim() != 2 \
            or gid.shape[1] % 32:
        raise ValueError(f"{name}: gid must be [P, N] with N % 32 == 0")
    P, N = gid.shape
    if P * N >= MAX_ROWS:
        raise ValueError(f"{name}: {P * N} rows; the int64 sums are exact "
                         f"only below {MAX_ROWS} rows")
    if not 0 <= G < MAX_ROWS:
        raise ValueError(f"{name}: G = {G}")
    dev = gid.device
    _check(gid, "gid", (P, N), dev)
    _check(mask_words, "mask_words", (P, N // 32), dev)
    for j, v in enumerate(vals):
        _check(v, f"vals[{j}]", (P, N), dev)
    if dev.type == "cpu":
        PLAIN_CALLS[name] += 1
        return _group_sums_torch(gid, mask_words, vals, G)
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    from .cuda_build import load
    lib = load()
    K = len(vals) // 2
    plan = group_tile_plan(P * N, G, K, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    out = torch.zeros((1 + len(vals), G), dtype=torch.int64, device=dev)
    ptrs = [v.data_ptr() for v in vals] + [None] * (4 - len(vals))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knox_group_sums(gid.data_ptr(), mask_words.data_ptr(),
                                  *ptrs, K, P * N, G, out.data_ptr(),
                                  MODES[plan.mode], plan.stages,
                                  plan.blocks, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
    LAUNCHES[name] += 1
    return tuple(out.unbind(0))


def fused_group_partials(gid, mask_words, vlo, vhi, G: int):
    """Per-group (counts, Σvlo, Σvhi), each int64[G]: the group sum is
    Σvlo + Σvhi * 2^32."""
    return _group_sums("fused_group_partials", gid, mask_words, (vlo, vhi),
                       G)


def fused_group_moments_partials(gid, mask_words, rlo, rhi, qlo, qhi,
                                 G: int):
    """Per-group (counts, Σrlo, Σrhi, Σqlo, Σqhi), each int64[G], from one
    pass over the rows."""
    return _group_sums("fused_group_moments_partials", gid, mask_words,
                       (rlo, rhi, qlo, qhi), G)
