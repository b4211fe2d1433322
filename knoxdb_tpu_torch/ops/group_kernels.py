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
G and K (each block's own 32-bit shared counters, or past what one block
holds one histogram in the shared memory of a thread block cluster), and
its launch geometry.

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
           "max_shared_groups", "cluster_smem", "cluster_shape",
           "cluster_plan", "cuda_plan", "launch"]

MAX_ROWS = 1 << 31      # exclusive: the sums stay below 2^63 under it

# csrc/group_kernels.cu. LIMBS and CLUSTER: rows per ring stage, threads
# per block (one producer warp, eight consumer warps), the shared memory of
# a block and of an SM, the ring's share of it and its most stages. LIMBS:
# the most chunks between two flushes, the largest limb, blocks per SM.
# CLUSTER: the cluster sizes, the largest one the kernel takes, the most
# chunks a round and the fewest it runs at (one chunk a round lost to the
# GLOBAL loop at every shape measured, PERF.md). GLOBAL: threads per
# block, rows per thread and blocks per SM.
CHUNK_ROWS = 1024
BLOCK_THREADS = 288
SMEM_BLOCK = 232448
SMEM_SM = 233472
RING_BYTES = 65536
MAX_STAGES = 4
LIMB_CHUNKS = 64
LIMB_MAX = (1 << 16) - 1
BLOCKS_PER_SM = 2
CLUSTER = 8                 # portable
CLUSTER_WIDE = 16           # non-portable: smaller slices, longer rounds
MAX_CLUSTER = 16
ROUND_CHUNKS = 4
MIN_ROUND_CHUNKS = 2
GLOBAL_THREADS = 256
GLOBAL_UNROLL = 4
GLOBAL_BLOCKS_PER_SM = 4
MODES = {"global": 0, "limbs": 1, "cluster": 2}

LAUNCHES = {"fused_group_partials": 0, "fused_group_moments_partials": 0}
PLAIN_CALLS = {"fused_group_partials": 0, "fused_group_moments_partials": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ------------------------------------------------------- launch geometry --

@dataclass(frozen=True)
class GroupPlan:
    """Launch geometry of knox_group_sums. mode: "limbs" (each block's own
    32-bit shared counters), "global" (u64 atomics in L2) or "cluster"
    (one histogram per thread block
    cluster of `cluster` CTAs, `slice` groups in each CTA's shared memory,
    in rounds of `round_chunks` chunks a CTA), both fed by a TMA ring of
    `stages` chunks. blocks: CTAs of the grid (for
    "cluster" a multiple of `cluster`); smem: dynamic shared memory of a
    CTA; hist_bytes: its counters; tile_rows: the most rows a LIMBS block
    adds between two flushes (0 for the others)."""
    mode: str
    stages: int
    blocks: int
    smem: int
    hist_bytes: int
    tile_rows: int
    cluster: int = 0
    slice: int = 0
    round_chunks: int = 0


def stage_bytes(K: int) -> int:
    """One ring stage: a chunk's gid and 2K value words, and its mask."""
    return CHUNK_ROWS * 4 * (1 + 2 * K) + CHUNK_ROWS // 8


def _ring(K: int) -> tuple[int, int]:
    """(stages, bytes) of the ring, its mbarriers included."""
    sb = stage_bytes(K)
    stages = max(2, min(MAX_STAGES, RING_BYTES // sb))
    return stages, stages * (sb + 16)


def max_shared_groups(K: int) -> int:
    """The most groups whose 4(1 + 4K) bytes of 32-bit counters fit beside
    the ring in one block's shared memory: the switch from "limbs" to
    "cluster"."""
    return (SMEM_BLOCK - _ring(K)[1]) // (4 * (1 + 4 * K))


def cluster_smem(K: int, slice_: int, round_chunks: int) -> int:
    """A CLUSTER CTA's shared memory: a ring of round_chunks + 1 stages,
    the slice's counters, two outboxes of a round's rows (each passing
    row's slice offset and 2K value words; each rank's bucket padded to 4
    entries) and the buckets' places and per-warp counts
    (csrc/group_kernels.cu cluster_smem)."""
    return (round_chunks + 1) * (stage_bytes(K) + 16) \
        + 4 * (1 + 4 * K) * slice_ \
        + 4 * 2 * (1 + 2 * K) * (round_chunks * CHUNK_ROWS + 3 * MAX_CLUSTER) \
        + 4 * 6 * MAX_CLUSTER


def cluster_shape(G: int, K: int, cluster: int | None = None):
    """(cluster size, slice, round_chunks) of the "cluster" form at G
    groups: the most chunks a round (1 to ROUND_CHUNKS) whose shared
    memory fits, then the smaller cluster (CLUSTER before CLUSTER_WIDE);
    `cluster` fixes the size. The slices, multiples of 4 groups, cover
    [0, G); None where no shape fits."""
    best = None
    for S in (cluster,) if cluster else (CLUSTER, CLUSTER_WIDE):
        sl = -(-G // S // 4) * 4                     # 16-byte outboxes
        rc = next((c for c in range(ROUND_CHUNKS, 0, -1)
                   if cluster_smem(K, sl, c) <= SMEM_BLOCK), None)
        if rc and (best is None or rc > best[2]):
            best = (S, sl, rc)
    return best


def cluster_plan(n: int, G: int, K: int, cluster: int, sms: int = 132,
                 clusters: int | None = None) -> GroupPlan:
    """The "cluster" form in clusters of `cluster` CTAs (cluster_shape) on
    `clusters` clusters (the card's cudaOccupancyMaxActiveClusters;
    sms // cluster when not given), no more than give every CTA a chunk;
    ValueError where no round fits."""
    shape = cluster_shape(G, K, cluster)
    if shape is None:
        raise ValueError(f"group kernel: no cluster of {cluster} holds "
                         f"G = {G}, K = {K}")
    S, slice_, rc = shape
    nchunks = -(-n // CHUNK_ROWS)
    nclusters = max(1, min(clusters or sms // S, -(-nchunks // S)))
    return GroupPlan("cluster", rc + 1, nclusters * S,
                     cluster_smem(K, slice_, rc), 4 * (1 + 4 * K) * slice_,
                     0, S, slice_, rc)


def group_tile_plan(n: int, G: int, K: int, sms: int = 132,
                    clusters: int | None = None) -> GroupPlan:
    """The group kernel's form and geometry for n rows (a multiple of 32),
    G groups and K value pairs on a card with `sms` SMs. "limbs" takes
    4(1 + 4K) bytes of counters per group beside the ring, and up to
    BLOCKS_PER_SM blocks per SM where they fit; G past max_shared_groups(K)
    runs "cluster" (cluster_plan, on `clusters` clusters) where its rounds
    hold MIN_ROUND_CHUNKS chunks or more (K = 1 to G = 115,520, K = 2 to
    38,336), else "global" at up to GLOBAL_BLOCKS_PER_SM blocks per SM."""
    if G > max_shared_groups(K):
        shape = cluster_shape(G, K)
        if shape is None or shape[2] < MIN_ROUND_CHUNKS:
            blocks = min(-(-n // (GLOBAL_THREADS * GLOBAL_UNROLL)),
                         sms * GLOBAL_BLOCKS_PER_SM)
            return GroupPlan("global", 0, max(1, blocks), 0, 0, 0)
        return cluster_plan(n, G, K, shape[0], sms, clusters)
    stages, ring = _ring(K)
    hist = 4 * (1 + 4 * K) * G
    smem = ring + hist
    per_sm = max(1, min(BLOCKS_PER_SM, SMEM_SM // (smem + 1024)))
    blocks = min(-(-n // CHUNK_ROWS), sms * per_sm)
    return GroupPlan("limbs", stages, max(1, blocks), smem, hist,
                     min(LIMB_CHUNKS * CHUNK_ROWS, n))


_MAX_CLUSTERS: dict = {}


def max_clusters(lib, dev, K: int, cluster: int, slice_: int,
                 round_chunks: int) -> int:
    """The card's cudaOccupancyMaxActiveClusters for the "cluster" form at
    this shape, asked once per device and shape."""
    key = (dev.index, K, cluster, slice_, round_chunks)
    if key not in _MAX_CLUSTERS:
        with torch.cuda.device(dev):
            got = lib.knox_group_max_clusters(K, cluster, slice_,
                                              round_chunks)
        if got <= 0:
            raise RuntimeError(f"group kernel: no cluster of {cluster} "
                               f"CTAs fits (cudaError_t {-got})")
        _MAX_CLUSTERS[key] = got
    return _MAX_CLUSTERS[key]


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
    plan = cuda_plan(lib, dev, P * N, G, len(vals) // 2)
    out = launch(lib, gid, mask_words, vals, G, plan)
    LAUNCHES[name] += 1
    return tuple(out.unbind(0))


def cuda_plan(lib, dev, n: int, G: int, K: int,
              cluster: int | None = None) -> GroupPlan:
    """group_tile_plan on the card of `dev`: its SMs and, for "cluster",
    its cudaOccupancyMaxActiveClusters. `cluster` forces the "cluster"
    form in clusters of that size (cluster_plan), for measurements."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = cluster_plan(n, G, K, cluster, sms) if cluster \
        else group_tile_plan(n, G, K, sms)
    if plan.mode != "cluster":
        return plan
    most = max_clusters(lib, dev, K, plan.cluster, plan.slice,
                        plan.round_chunks)
    return cluster_plan(n, G, K, plan.cluster, sms, most)


def launch(lib, gid, mask_words, vals, G: int, plan: GroupPlan):
    """One knox_group_sums launch in `plan`'s geometry on checked CUDA
    operands: the output int64[1 + 2K, G]; raises on a launch error."""
    dev = gid.device
    K = len(vals) // 2
    out = torch.zeros((1 + len(vals), G), dtype=torch.int64, device=dev)
    ptrs = [v.data_ptr() for v in vals] + [None] * (4 - len(vals))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knox_group_sums(
            gid.data_ptr(), mask_words.data_ptr(), *ptrs, K, gid.numel(), G,
            out.data_ptr(), MODES[plan.mode], plan.stages, plan.blocks,
            plan.cluster, plan.slice, plan.round_chunks, stream)
    if err != 0:
        raise RuntimeError(f"group kernel: CUDA launch failed with "
                           f"cudaError_t {err}")
    return out


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
