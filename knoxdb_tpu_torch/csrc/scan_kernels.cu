// Fused bit-sliced scan kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of knoxdb_tpu/ops/pallas_scan.py:
//   _kernel_masked (fused_range_sum_masked) -> knox_fused_range_sum_masked
//   _kernel_tree   (fused_tree_agg)         -> knox_fused_tree_agg
// Both host entry points launch the one fused __global__ kernel below; the
// single-leaf entry is the tree kernel with one leaf and one sum spec.
//
// And the two split bodies of probes/ps_variants.py, which the scan runs
// for every leaf and every sum that does not ride the fused kernel:
//   k_ladder_only -> knox_range_mask_count       (range_mask_count_kernel)
//   k_pcnt_only   -> knox_masked_plane_popcounts (masked_popcounts_kernel)
// Each is its own __global__ entry with a body of its own, a pack split
// over a thread block cluster (see the note before range_mask_count_kernel).
//
// Plane layout: every entry addresses word j of plane p of pack k at
// planes[p * plane_stride + k * pack_stride + j] (strides in words). The
// plane-major tensor u32[w, P, W] has strides (P * W, W); a pack-major
// tensor u32[P, w, W] runs as its permuted view with strides (W, w * W),
// without a copy (the probe's k_v0 / k_v6 against k_v4 / k_v7 layouts).
// The tree entry takes contiguous plane-major fields only.
//
// Per pack (one block per pack, grid = P):
//   1. every fused AND leaf runs an MSB-down range ladder over its field's
//      planes u32[w, P, W] against per-plane select words lo/hi u32[P, w1]
//      and five degenerate-pack flag words u32[P, 8]; the leaves are ANDed
//      with mask_in (validity, excludes and the rest of the filter tree);
//   2. the match mask is stored, and its popcount is the pack's count;
//   3. per aggregate spec: masked per-plane popcounts (the host forms the
//      exact sum Σ 2^p·c_p + min_key·count) and/or the masked min and max
//      by MSB-down candidate narrowing, as pack-relative u32 halves
//      (mn_lo, mn_hi, mx_lo, mx_hi, 0, 0, 0, 0). An empty pack reads
//      mn = all ones in its low w bits and mx = 0; callers gate on count.
//
// What bounds it on the H100: bytes. The work is a few integer ops per
// 32 rows per plane, far below the card's integer rate, so the kernel is
// a stream over the planes (16 planes x 256 packs x 8 KiB = 32 MiB per
// query for the benchmark's 16-bit column, plus 4 MiB of masks in and
// out). The design keeps each thread's mask words in registers between
// the ladder and the aggregates (the TPU kept them in VMEM), loads words
// coalesced (neighbouring threads read neighbouring words of a plane),
// and keeps WPT words per thread in flight per plane step so that each
// thread has several independent loads outstanding.
//
// The fused kernel reaches about a third of that bound (PERF.md). Three
// causes were named: a 256-thread block per pack with loads into registers
// a few planes ahead, planes re-read from L2 / HBM by the aggregate passes,
// and a min / max chain paced by two __syncthreads_or per plane. A Hopper
// body that answered each was built and measured against this one, in
// turns, on the main paths' operands (commit e351633 holds its source): a
// pack split over a thread block cluster of 1-8 CTAs, plane rows staged
// in shared memory by cp.async (a first form by TMA 1-D bulk copies),
// re-read fields resident there, per-thread min / max narrowing without
// block barriers, and a distributed-shared-memory combine. It lost at
// every main-path shape (config #1 0.0335 against 0.0224 ms, entry()
// 0.1091 against 0.1050): the kernel is latency-bound per warp, not
// byte-bound (warm and L2-flushed times differ little); a thread reads
// only its own words, so staging adds a wait and a shared load per plane
// and reuses nothing; L2 already serves the re-reads, and residency costs
// warps per SM. This body stays.
//
// Integer reductions: per-thread __popc, a warp __reduce_add_sync, then
// integer atomics in shared memory, so every result is deterministic.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define KNOX_MAX_FIELDS 8
#define KNOX_MAX_LEAVES 8
#define KNOX_MAX_SPECS 8
#define KNOX_MAX_WIDTH 64
#define KNOX_NFLAGS 8
#define KNOX_MM_COLS 8
#define KNOX_MAX_THREADS 256
// the split kernels' geometry (split_geom) and planes in flight per thread
#define KNOX_MAX_CLUSTER 8           // CTAs per pack (a portable cluster)
#define KNOX_SPLIT_THREADS 512       // threads (quads of 4 words) per CTA
#define KNOX_LADDER_D 2              // 5a
#define KNOX_PCNT_D 4                // 5b

// flag word columns, as written by range_consts (ops/scan_kernels.py)
#define F_LO_LT_ALL 0
#define F_LO_GE_NONE 1
#define F_HI_IN 2
#define F_HI_GE_NONE 3
#define F_HI_LT_ALL 4

struct TreeParams {
    const uint32_t* planes[KNOX_MAX_FIELDS];   // [w_f, P, W] per field
    long long plane_stride[KNOX_MAX_FIELDS];   // words between planes
    long long pack_stride[KNOX_MAX_FIELDS];    // words between packs
    int fwidth[KNOX_MAX_FIELDS];
    const uint32_t* lo_bits[KNOX_MAX_LEAVES];  // [P, max(w, 1)] per leaf
    const uint32_t* hi_bits[KNOX_MAX_LEAVES];
    const uint32_t* flags[KNOX_MAX_LEAVES];    // [P, 8]
    int leaf_field[KNOX_MAX_LEAVES];
    int spec_field[KNOX_MAX_SPECS];
    int32_t* pcnt[KNOX_MAX_SPECS];             // [P, max(w, 1)] or null
    uint32_t* mnmx[KNOX_MAX_SPECS];            // [P, 8] or null
    const uint32_t* mask_in;                   // [P, W]
    uint32_t* mask_out;                        // [P, W]
    int32_t* cnt;                              // [P]
    int nleaf, nspec, P, W;
};

// The fused kernel's plane loops are unrolled by hand. The kernel waits on
// loads, and a pack's one block has too few threads to cover the latency
// unless each thread keeps the words of several planes in flight; nvcc's
// own choice flips with the address form (it unrolled the ladder for the
// plane-major form only: 0.0224 ms on the benchmark's 16-plane column at
// 256 packs, against 0.037 ms once the pack offset came from a stride).
// Measured on NVIDIA H100 80GB HBM3, 700.00 W, ms with the planes warm in
// L2 / with L2 flushed, 8 words per thread: the ladder x4 0.0218 / 0.0339
// (x8 0.0215 / 0.0357, none 0.0256 / 0.0369; 107 registers, no spills);
// the popcount loop x8 0.0170 / 0.0325 (none 0.0246 / 0.0493; 40
// registers; measured in 5b's former body, which shared it). At 16 words
// per thread the ladder keeps two planes.

// Block-wide integer sum; every thread calls it with its value.
__device__ __forceinline__ int block_sum(unsigned v, int* slot) {
    if (threadIdx.x == 0) *slot = 0;
    __syncthreads();
    v = __reduce_add_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(slot, (int)v);
    __syncthreads();
    const int out = *slot;
    __syncthreads();
    return out;
}

// One leaf's MSB-down range ladder over this pack: m[k] &= (lo <= x <= hi)
// for the WPT words each thread holds. pl points at plane 0 of the pack;
// lob / hib at the pack's per-plane select words, fl at its flag words.
template <int WPT, int UNROLL>
__device__ __forceinline__ void range_ladder(
        const uint32_t* pl, size_t plane_stride, int w, const uint32_t* lob,
        const uint32_t* hib, const uint32_t* fl, int W, uint32_t (&m)[WPT]) {
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;
    uint32_t lt_lo[WPT], eq_lo[WPT], lt_hi[WPT], eq_hi[WPT];
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
        lt_lo[k] = 0u; eq_lo[k] = ~0u; lt_hi[k] = 0u; eq_hi[k] = ~0u;
    }
#pragma unroll UNROLL
    for (int p = w - 1; p >= 0; --p) {
        const uint32_t cl = __ldg(lob + p);
        const uint32_t ch = __ldg(hib + p);
        const uint32_t* row = pl + (size_t)p * plane_stride;
#pragma unroll
        for (int k = 0; k < WPT; ++k) {
            const int j = tid + k * nthr;
            const uint32_t x = j < W ? __ldg(row + j) : 0u;
            lt_lo[k] |= eq_lo[k] & ~x & cl;
            eq_lo[k] &= ~(x ^ cl);
            lt_hi[k] |= eq_hi[k] & ~x & ch;
            eq_hi[k] &= ~(x ^ ch);
        }
    }
    const uint32_t f_lo_lt_all = __ldg(fl + F_LO_LT_ALL);
    const uint32_t f_lo_ge_none = __ldg(fl + F_LO_GE_NONE);
    const uint32_t f_hi_in = __ldg(fl + F_HI_IN);
    const uint32_t f_hi_ge_none = __ldg(fl + F_HI_GE_NONE);
    const uint32_t f_hi_lt_all = __ldg(fl + F_HI_LT_ALL);
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
        const uint32_t ge_lo = ~((lt_lo[k] | f_lo_lt_all) & ~f_lo_ge_none);
        uint32_t le_hi = lt_hi[k] | (eq_hi[k] & f_hi_in) | f_hi_lt_all;
        le_hi &= ~f_hi_ge_none;
        m[k] &= ge_lo & le_hi;
    }
}

// Per-plane popcounts of this pack's planes under the mask words m, into
// s_acc[0..w) (shared, KNOX_MAX_WIDTH ints). Every thread of the block
// calls it; s_acc is complete when it returns.
template <int WPT>
__device__ __forceinline__ void plane_popcounts(
        const uint32_t* pl, size_t plane_stride, int w, int W,
        const uint32_t (&m)[WPT], int* s_acc) {
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;
    for (int i = tid; i < KNOX_MAX_WIDTH; i += nthr) s_acc[i] = 0;
    __syncthreads();
#pragma unroll (WPT >= 16 ? 2 : 8)
    for (int p = 0; p < w; ++p) {
        const uint32_t* row = pl + (size_t)p * plane_stride;
        unsigned pc = 0;
#pragma unroll
        for (int k = 0; k < WPT; ++k) {
            const int j = tid + k * nthr;
            if (j < W) pc += __popc(__ldg(row + j) & m[k]);
        }
        pc = __reduce_add_sync(0xffffffffu, pc);
        if ((tid & 31) == 0 && pc) atomicAdd(&s_acc[p], (int)pc);
    }
    __syncthreads();
}

template <int WPT>
__global__ void __launch_bounds__(KNOX_MAX_THREADS)
fused_tree_kernel(const TreeParams prm) {
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;
    const int W = prm.W;
    const size_t base = (size_t)blockIdx.x * W;
    __shared__ int s_acc[KNOX_MAX_WIDTH];
    __shared__ int s_sum;

    uint32_t m[WPT];
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
        const int j = tid + k * nthr;
        m[k] = j < W ? prm.mask_in[base + j] : 0u;
    }

    // 1. range ladders of the fused AND leaves
    for (int l = 0; l < prm.nleaf; ++l) {
        const int f = prm.leaf_field[l];
        const int w = prm.fwidth[f];
        const size_t cbase = (size_t)blockIdx.x * (w > 1 ? w : 1);
        range_ladder<WPT, (WPT >= 16 ? 2 : 4)>(
            prm.planes[f] + (size_t)blockIdx.x * prm.pack_stride[f],
            (size_t)prm.plane_stride[f], w, prm.lo_bits[l] + cbase,
            prm.hi_bits[l] + cbase,
            prm.flags[l] + (size_t)blockIdx.x * KNOX_NFLAGS, W, m);
    }

    // 2. match mask and its count
    unsigned c = 0;
#pragma unroll
    for (int k = 0; k < WPT; ++k) {
        const int j = tid + k * nthr;
        if (j < W) {
            prm.mask_out[base + j] = m[k];
            c += __popc(m[k]);
        }
    }
    const int total = block_sum(c, &s_sum);
    if (tid == 0) prm.cnt[blockIdx.x] = total;

    // 3. aggregate partials, per spec
    for (int s = 0; s < prm.nspec; ++s) {
        const int f = prm.spec_field[s];
        const int w = prm.fwidth[f];
        const uint32_t* pl = prm.planes[f]
            + (size_t)blockIdx.x * prm.pack_stride[f];
        const size_t pstride = (size_t)prm.plane_stride[f];
        if (prm.pcnt[s]) {
            plane_popcounts<WPT>(pl, pstride, w, W, m, s_acc);
            const int w1 = w > 1 ? w : 1;
            int32_t* out = prm.pcnt[s] + (size_t)blockIdx.x * w1;
            for (int i = tid; i < w1; i += nthr) out[i] = i < w ? s_acc[i] : 0;
            __syncthreads();
        }
        if (prm.mnmx[s]) {
            uint32_t cmn[WPT], cmx[WPT];
#pragma unroll
            for (int k = 0; k < WPT; ++k) { cmn[k] = m[k]; cmx[k] = m[k]; }
            uint32_t mn_lo = 0u, mn_hi = 0u, mx_lo = 0u, mx_hi = 0u;
            for (int p = w - 1; p >= 0; --p) {
                const uint32_t* row = pl + p * pstride;
                uint32_t tmn[WPT], tmx[WPT];
                uint32_t any_mn = 0u, any_mx = 0u;
#pragma unroll
                for (int k = 0; k < WPT; ++k) {
                    const int j = tid + k * nthr;
                    const uint32_t x = j < W ? __ldg(row + j) : 0u;
                    tmn[k] = cmn[k] & ~x;
                    tmx[k] = cmx[k] & x;
                    any_mn |= tmn[k];
                    any_mx |= tmx[k];
                }
                // pack-wide "does any candidate survive" (the TPU
                // kernel's per-pack `has`)
                const int has_mn = __syncthreads_or(any_mn != 0u);
                const int has_mx = __syncthreads_or(any_mx != 0u);
                if (has_mn) {
#pragma unroll
                    for (int k = 0; k < WPT; ++k) cmn[k] = tmn[k];
                }
                if (has_mx) {
#pragma unroll
                    for (int k = 0; k < WPT; ++k) cmx[k] = tmx[k];
                }
                const uint32_t bmn = has_mn ? 0u : 1u;   // min bit 1 iff no 0
                const uint32_t bmx = has_mx ? 1u : 0u;
                if (p < 32) {
                    mn_lo |= bmn << p;
                    mx_lo |= bmx << p;
                } else {
                    mn_hi |= bmn << (p - 32);
                    mx_hi |= bmx << (p - 32);
                }
            }
            if (tid == 0) {
                uint32_t* out = prm.mnmx[s] + (size_t)blockIdx.x * KNOX_MM_COLS;
                out[0] = mn_lo;
                out[1] = mn_hi;
                out[2] = mx_lo;
                out[3] = mx_hi;
                for (int i = 4; i < KNOX_MM_COLS; ++i) out[i] = 0u;
            }
        }
    }
}


// ---- the split kernels 5a / 5b: one pack over a thread block cluster ----
//
// CTA `rank` of a pack's S CTAs owns q quads of four words: in the vector
// form the words 4 * (rank * q + t) .. + 3 of thread t, read as one 16-byte
// load; in the scalar form (W % 4 != 0, or a base or stride that is not
// 16-byte aligned) the words rank * 4q + t + k * q, k = 0..3, each a
// coalesced 4-byte load. A thread keeps D planes' loads in flight in
// registers (a ring of D quads), its ladder state and mask words in
// registers, and no block barrier runs inside the plane loop. Counts go
// __popc -> warp __reduce_add_sync -> one shared atomic per warp; where
// S > 1 the pack's CTAs form a thread block cluster and add their partials
// into rank 0 through distributed shared memory. Every output is written
// once, by one CTA.
//
// What bounds them: bytes (each plane word is read once for a few integer
// operations), and a fixed cost of about 6 us a launch, a quarter of the
// time on the main paths' 16-32-plane columns. Measured on NVIDIA H100 80GB
// HBM3, 700.00 W, in turns on the main paths' operands (ab_kernels.py split,
// L2 flushed, 5a on config #4's 64 planes x 256 packs): the bodies of commit
// 68506b1 (a block of 256 threads per pack, 8 scalar words a thread) took
// 0.0900 ms, 12-46% of the HBM bound across the operand sets; this body with
// 64, 128 and 256 quads per CTA (clusters of 8, 4 and 2 at W = 2048) 0.1131,
// 0.0895 and 0.0639, and with 512 (one CTA per pack) 0.0637 launched as a
// cluster and 0.0628 without the attribute: a cluster launch costs about 1.5
// us even for one CTA (0.0081 against 0.0065 at width 0). So W <= 2048 runs
// one CTA of 512 threads per pack as a plain launch, and clusters run where
// W > 2048. D mattered little (5a D = 4 and 8: +3% and +4%; 5b D = 2 and 8:
// +2% and +3%). 5a 0.0241 against 0.0317 on config #2's 16 planes; 5b 0.0639
// against 0.0881. ptxas: 5a 54 registers (16-byte form) / 61 (scalar), 5b 32
// / 40, no spills.

// A thread's four words of one row (a plane of a pack, or a mask row),
// read only where `live`: VEC one 16-byte load of words j..j+3, else the
// words j + k * step that lie below W (the rest read as 0).
template <bool VEC>
__device__ __forceinline__ uint4 load_quad(const uint32_t* row, int j,
                                           int step, int W, bool live) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (!live) return v;
    if (VEC) return __ldg(reinterpret_cast<const uint4*>(row + j));
    if (j < W) v.x = __ldg(row + j);
    if (j + step < W) v.y = __ldg(row + j + step);
    if (j + 2 * step < W) v.z = __ldg(row + j + 2 * step);
    if (j + 3 * step < W) v.w = __ldg(row + j + 3 * step);
    return v;
}

// All ones on the thread's words that lie below W (no incoming mask).
template <bool VEC>
__device__ __forceinline__ uint4 all_rows_quad(int j, int step, int W,
                                               bool live) {
    if (!live) return make_uint4(0u, 0u, 0u, 0u);
    if (VEC) return make_uint4(~0u, ~0u, ~0u, ~0u);
    return make_uint4(j < W ? ~0u : 0u, j + step < W ? ~0u : 0u,
                      j + 2 * step < W ? ~0u : 0u,
                      j + 3 * step < W ? ~0u : 0u);
}

__device__ __forceinline__ unsigned popc_quad(uint4 v) {
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

// One warp's value into a shared counter: one atomic per warp.
__device__ __forceinline__ void warp_add(unsigned v, int* slot) {
    v = __reduce_add_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(slot, (int)v);
}

// One plane of the MSB-down range ladder on one word.
__device__ __forceinline__ void ladder_word(uint32_t x, uint32_t cl,
                                            uint32_t ch, uint32_t& lt_lo,
                                            uint32_t& eq_lo, uint32_t& lt_hi,
                                            uint32_t& eq_hi) {
    lt_lo |= eq_lo & ~x & cl;
    eq_lo &= ~(x ^ cl);
    lt_hi |= eq_hi & ~x & ch;
    eq_hi &= ~(x ^ ch);
}

// The thread's place in its pack: the first word j, the step between its
// words, and whether it owns any word.
struct SplitSlot {
    int pack, rank, j, step;
    bool live;
};

template <bool VEC>
__device__ __forceinline__ SplitSlot split_slot(int S, int q, int W) {
    SplitSlot s;
    s.pack = blockIdx.x / S;
    s.rank = blockIdx.x % S;          // the CTA's rank in its (S, 1, 1) cluster
    const int t = threadIdx.x;
    s.j = VEC ? (s.rank * q + t) * 4 : s.rank * 4 * q + t;
    s.step = VEC ? 1 : q;
    s.live = t < q && s.j < W;
    return s;
}

// probes/ps_variants.py k_ladder_only: one column's range ladder AND an
// optional incoming mask (null = all rows) -> the mask and its count.
template <bool VEC>
__global__ void __launch_bounds__(KNOX_SPLIT_THREADS)
range_mask_count_kernel(const uint32_t* planes, int w, size_t plane_stride,
                        size_t pack_stride, const uint32_t* lo_bits,
                        const uint32_t* hi_bits, const uint32_t* flags,
                        const uint32_t* mask_in, uint32_t* mask_out,
                        long long* cnt, int W, int q) {
    constexpr int D = KNOX_LADDER_D;
    cg::cluster_group cluster = cg::this_cluster();
    const int S = (int)cluster.num_blocks();
    const SplitSlot s = split_slot<VEC>(S, q, W);
    __shared__ uint32_t s_lo[KNOX_MAX_WIDTH], s_hi[KNOX_MAX_WIDTH];
    __shared__ int s_cnt;
    const size_t cbase = (size_t)s.pack * (w > 1 ? w : 1);
    for (int i = threadIdx.x; i < w; i += blockDim.x) {
        s_lo[i] = __ldg(lo_bits + cbase + i);
        s_hi[i] = __ldg(hi_bits + cbase + i);
    }
    if (threadIdx.x == 0) s_cnt = 0;

    const uint32_t* pl = planes + (size_t)s.pack * pack_stride;
    const size_t row = (size_t)s.pack * W;
    // the ring: planes w-1 .. w-D in flight before the barrier
    uint4 ring[D];
#pragma unroll
    for (int d = 0; d < D; ++d)
        ring[d] = load_quad<VEC>(
            pl + (size_t)max(w - 1 - d, 0) * plane_stride, s.j, s.step, W,
            s.live && w - 1 - d >= 0);
    const uint4 m_in = mask_in
        ? load_quad<VEC>(mask_in + row, s.j, s.step, W, s.live)
        : all_rows_quad<VEC>(s.j, s.step, W, s.live);
    __syncthreads();

    uint32_t lt_lo[4] = {0u, 0u, 0u, 0u}, eq_lo[4] = {~0u, ~0u, ~0u, ~0u};
    uint32_t lt_hi[4] = {0u, 0u, 0u, 0u}, eq_hi[4] = {~0u, ~0u, ~0u, ~0u};
    for (int p0 = w - 1; p0 >= 0; p0 -= D) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const int p = p0 - d;
            if (p >= 0) {
                const uint4 x = ring[d];
                const int next = p - D;
                ring[d] = load_quad<VEC>(
                    pl + (size_t)max(next, 0) * plane_stride, s.j, s.step, W,
                    s.live && next >= 0);
                const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
                const uint32_t cl = s_lo[p], ch = s_hi[p];
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    ladder_word(xs[k], cl, ch, lt_lo[k], eq_lo[k], lt_hi[k],
                                eq_hi[k]);
            }
        }
    }

    const uint32_t* fl = flags + (size_t)s.pack * KNOX_NFLAGS;
    const uint32_t f_lo_lt_all = __ldg(fl + F_LO_LT_ALL);
    const uint32_t f_lo_ge_none = __ldg(fl + F_LO_GE_NONE);
    const uint32_t f_hi_in = __ldg(fl + F_HI_IN);
    const uint32_t f_hi_ge_none = __ldg(fl + F_HI_GE_NONE);
    const uint32_t f_hi_lt_all = __ldg(fl + F_HI_LT_ALL);
    uint32_t m[4] = {m_in.x, m_in.y, m_in.z, m_in.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t ge_lo = ~((lt_lo[k] | f_lo_lt_all) & ~f_lo_ge_none);
        const uint32_t le_hi = (lt_hi[k] | (eq_hi[k] & f_hi_in) | f_hi_lt_all)
            & ~f_hi_ge_none;
        m[k] &= ge_lo & le_hi;
    }
    if (s.live) {
        if (VEC) {
            *reinterpret_cast<uint4*>(mask_out + row + s.j) =
                make_uint4(m[0], m[1], m[2], m[3]);
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (s.j + k * s.step < W)
                    mask_out[row + s.j + k * s.step] = m[k];
        }
    }
    warp_add(popc_quad(make_uint4(m[0], m[1], m[2], m[3])), &s_cnt);

    cluster.sync();                  // every CTA's s_cnt is complete
    if (s.rank == 0 && threadIdx.x == 0) {
        long long total = 0;
        for (int r = 0; r < S; ++r)
            total += *cluster.map_shared_rank(&s_cnt, r);
        cnt[s.pack] = total;
    }
    cluster.sync();                  // no CTA leaves while rank 0 reads it
}

// probes/ps_variants.py k_pcnt_only: the count of a mask that arrives from
// outside and the per-plane popcounts of one column's planes under it.
template <bool VEC>
__global__ void __launch_bounds__(KNOX_SPLIT_THREADS)
masked_popcounts_kernel(const uint32_t* planes, int w, size_t plane_stride,
                        size_t pack_stride, const uint32_t* mask,
                        long long* pcnt, long long* cnt, int W, int q) {
    constexpr int D = KNOX_PCNT_D;
    cg::cluster_group cluster = cg::this_cluster();
    const int S = (int)cluster.num_blocks();
    const SplitSlot s = split_slot<VEC>(S, q, W);
    __shared__ int s_acc[KNOX_MAX_WIDTH];
    __shared__ int s_cnt;
    for (int i = threadIdx.x; i < w; i += blockDim.x) s_acc[i] = 0;
    if (threadIdx.x == 0) s_cnt = 0;

    const uint32_t* pl = planes + (size_t)s.pack * pack_stride;
    uint4 ring[D];
#pragma unroll
    for (int d = 0; d < D; ++d)
        ring[d] = load_quad<VEC>(pl + (size_t)min(d, w) * plane_stride, s.j,
                                 s.step, W, s.live && d < w);
    const uint4 m = load_quad<VEC>(mask + (size_t)s.pack * W, s.j, s.step, W,
                                   s.live);
    __syncthreads();
    warp_add(popc_quad(m), &s_cnt);

    for (int p0 = 0; p0 < w; p0 += D) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const int p = p0 + d;
            if (p < w) {
                const uint4 x = ring[d];
                const int next = p + D;
                ring[d] = load_quad<VEC>(
                    pl + (size_t)min(next, w) * plane_stride, s.j, s.step, W,
                    s.live && next < w);
                warp_add(__popc(x.x & m.x) + __popc(x.y & m.y)
                         + __popc(x.z & m.z) + __popc(x.w & m.w), &s_acc[p]);
            }
        }
    }

    cluster.sync();                  // every CTA's partials are complete
    if (s.rank == 0) {
        const int w1 = w > 1 ? w : 1;
        long long* out = pcnt + (size_t)s.pack * w1;
        for (int i = threadIdx.x; i < w1; i += blockDim.x) {
            long long v = 0;
            if (i < w)
                for (int r = 0; r < S; ++r)
                    v += cluster.map_shared_rank(s_acc, r)[i];
            out[i] = v;
        }
        if (threadIdx.x == 0) {
            long long total = 0;
            for (int r = 0; r < S; ++r)
                total += *cluster.map_shared_rank(&s_cnt, r);
            cnt[s.pack] = total;
        }
    }
    cluster.sync();                  // no CTA leaves while rank 0 reads it
}

// threads: one per word up to 256 (at least one warp); WPT words each
static int block_threads(int W) {
    int nthr = W < KNOX_MAX_THREADS ? W : KNOX_MAX_THREADS;
    if (nthr < 32) nthr = 32;
    return (nthr + 31) / 32 * 32;
}

// Launch KERNEL<WPT> for the smallest WPT in {1, 2, 4, 8, 16} that covers
// W words with nthr threads.
#define KNOX_LAUNCH_WPT(KERNEL, P, W, stream, ...)                          \
    do {                                                                    \
        const int nthr_ = block_threads(W);                                 \
        const int wpt_ = ((W) + nthr_ - 1) / nthr_;                         \
        if (wpt_ <= 1) KERNEL<1><<<(P), nthr_, 0, stream>>>(__VA_ARGS__);   \
        else if (wpt_ <= 2)                                                 \
            KERNEL<2><<<(P), nthr_, 0, stream>>>(__VA_ARGS__);              \
        else if (wpt_ <= 4)                                                 \
            KERNEL<4><<<(P), nthr_, 0, stream>>>(__VA_ARGS__);              \
        else if (wpt_ <= 8)                                                 \
            KERNEL<8><<<(P), nthr_, 0, stream>>>(__VA_ARGS__);              \
        else if (wpt_ <= 16)                                                \
            KERNEL<16><<<(P), nthr_, 0, stream>>>(__VA_ARGS__);             \
        else return (int)cudaErrorInvalidValue;                             \
    } while (0)

static int launch(const TreeParams& prm, cudaStream_t stream) {
    if (prm.P <= 0 || prm.W <= 0 || prm.nleaf < 0 || prm.nleaf > KNOX_MAX_LEAVES
        || prm.nspec < 0 || prm.nspec > KNOX_MAX_SPECS)
        return (int)cudaErrorInvalidValue;
    KNOX_LAUNCH_WPT(fused_tree_kernel, prm.P, prm.W, stream, prm);
    return (int)cudaGetLastError();
}

// The split kernels' geometry, from W and the operands' alignment alone:
// S CTAs per pack (a power of two up to 8) of KNOX_SPLIT_THREADS quads each
// where W allows, threads rounded up to whole warps; the 16-byte form
// where W % 4 == 0 and every row is 16-byte aligned.
struct SplitGeom {
    int S, q, nthr;
    bool vec;
};

static bool split_geom(int W, bool aligned, SplitGeom* g) {
    const int nquad = (W + 3) / 4;
    int S = 1;
    while (S < KNOX_MAX_CLUSTER && S * KNOX_SPLIT_THREADS < nquad) S *= 2;
    g->S = S;
    g->q = (nquad + S - 1) / S;
    g->nthr = (g->q + 31) / 32 * 32;
    g->vec = aligned && W % 4 == 0;
    return g->nthr <= KNOX_SPLIT_THREADS;
}

static bool aligned16(const void* p) {
    return p == nullptr || ((uintptr_t)p & 15u) == 0;
}

// Launch a split kernel on a grid of P * S CTAs in clusters of (S, 1, 1);
// S = 1 launches without the cluster attribute, which costs even a cluster
// of one CTA about 1.5 us a launch (measured, see the note above).
template <typename... Params, typename... Args>
static int launch_split(void (*kernel)(Params...), int P, const SplitGeom& g,
                        cudaStream_t stream, Args... args) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)g.S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)P * (unsigned)g.S, 1, 1);
    cfg.blockDim = dim3((unsigned)g.nthr, 1, 1);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = g.S > 1 ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// KERNEL in the load form of the geometry g.
#define KNOX_LAUNCH_SPLIT(KERNEL, P, g, stream, ...)                         \
    ((g).vec ? launch_split(KERNEL<true>, P, g, stream, __VA_ARGS__)         \
             : launch_split(KERNEL<false>, P, g, stream, __VA_ARGS__))

extern "C" {

// Whole-AND-tree scan with every fused aggregate (fused_tree_agg).
// Pointer arrays hold one entry per field / leaf / spec; a null pcnt or
// mnmx entry skips that partial. Returns a cudaError_t value.
int knox_fused_tree_agg(const void* const* planes, const int* fwidths,
                        int nfield, const void* const* lo_bits,
                        const void* const* hi_bits, const void* const* flags,
                        const int* leaf_field, int nleaf,
                        const int* spec_field, void* const* pcnt,
                        void* const* mnmx, int nspec, const void* mask_in,
                        void* mask_out, void* cnt, int P, int W,
                        void* stream) {
    if (nfield < 0 || nfield > KNOX_MAX_FIELDS || nleaf < 0
        || nleaf > KNOX_MAX_LEAVES || nspec < 0 || nspec > KNOX_MAX_SPECS)
        return (int)cudaErrorInvalidValue;
    TreeParams prm = {};
    for (int f = 0; f < nfield; ++f) {
        if (fwidths[f] < 0 || fwidths[f] > KNOX_MAX_WIDTH)
            return (int)cudaErrorInvalidValue;
        prm.planes[f] = (const uint32_t*)planes[f];
        prm.plane_stride[f] = (long long)P * W;
        prm.pack_stride[f] = W;
        prm.fwidth[f] = fwidths[f];
    }
    for (int l = 0; l < nleaf; ++l) {
        if (leaf_field[l] < 0 || leaf_field[l] >= nfield)
            return (int)cudaErrorInvalidValue;
        prm.lo_bits[l] = (const uint32_t*)lo_bits[l];
        prm.hi_bits[l] = (const uint32_t*)hi_bits[l];
        prm.flags[l] = (const uint32_t*)flags[l];
        prm.leaf_field[l] = leaf_field[l];
    }
    for (int s = 0; s < nspec; ++s) {
        if (spec_field[s] < 0 || spec_field[s] >= nfield)
            return (int)cudaErrorInvalidValue;
        prm.spec_field[s] = spec_field[s];
        prm.pcnt[s] = (int32_t*)pcnt[s];
        prm.mnmx[s] = (uint32_t*)mnmx[s];
    }
    prm.mask_in = (const uint32_t*)mask_in;
    prm.mask_out = (uint32_t*)mask_out;
    prm.cnt = (int32_t*)cnt;
    prm.nleaf = nleaf;
    prm.nspec = nspec;
    prm.P = P;
    prm.W = W;
    return launch(prm, (cudaStream_t)stream);
}

// One-leaf range filter AND mask_in, with the filtered column's per-plane
// masked popcounts (fused_range_sum_masked). plane_stride and pack_stride
// are in words (see the layout note above). Returns a cudaError_t value.
int knox_fused_range_sum_masked(const void* planes, int width,
                                long long plane_stride, long long pack_stride,
                                const void* lo_bits, const void* hi_bits,
                                const void* flags, const void* mask_in,
                                void* mask_out, void* pcnt, void* cnt, int P,
                                int W, void* stream) {
    if (width < 0 || width > KNOX_MAX_WIDTH || plane_stride < 0
        || pack_stride < 0)
        return (int)cudaErrorInvalidValue;
    TreeParams prm = {};
    prm.planes[0] = (const uint32_t*)planes;
    prm.plane_stride[0] = plane_stride;
    prm.pack_stride[0] = pack_stride;
    prm.fwidth[0] = width;
    prm.lo_bits[0] = (const uint32_t*)lo_bits;
    prm.hi_bits[0] = (const uint32_t*)hi_bits;
    prm.flags[0] = (const uint32_t*)flags;
    prm.leaf_field[0] = 0;
    prm.spec_field[0] = 0;
    prm.pcnt[0] = (int32_t*)pcnt;
    prm.mnmx[0] = nullptr;
    prm.mask_in = (const uint32_t*)mask_in;
    prm.mask_out = (uint32_t*)mask_out;
    prm.cnt = (int32_t*)cnt;
    prm.nleaf = 1;
    prm.nspec = 1;
    prm.P = P;
    prm.W = W;
    return launch(prm, (cudaStream_t)stream);
}

// One column's range ladder AND mask_in (null = every row) -> mask_out
// u32[P, W] and cnt i64[P] (range_mask_count). Returns a cudaError_t value.
int knox_range_mask_count(const void* planes, int width,
                          long long plane_stride, long long pack_stride,
                          const void* lo_bits, const void* hi_bits,
                          const void* flags, const void* mask_in,
                          void* mask_out, void* cnt, int P, int W,
                          void* stream) {
    SplitGeom g;
    if (width < 0 || width > KNOX_MAX_WIDTH || plane_stride < 0
        || pack_stride < 0 || P <= 0 || W <= 0
        || !split_geom(W, plane_stride % 4 == 0 && pack_stride % 4 == 0
                              && aligned16(planes) && aligned16(mask_in)
                              && aligned16(mask_out), &g))
        return (int)cudaErrorInvalidValue;
    return KNOX_LAUNCH_SPLIT(
        range_mask_count_kernel, P, g, (cudaStream_t)stream,
        (const uint32_t*)planes, width, (size_t)plane_stride,
        (size_t)pack_stride, (const uint32_t*)lo_bits,
        (const uint32_t*)hi_bits, (const uint32_t*)flags,
        (const uint32_t*)mask_in, (uint32_t*)mask_out, (long long*)cnt, W,
        g.q);
}

// Per-plane popcounts of one column under mask u32[P, W] -> pcnt
// i64[P, max(width, 1)] and cnt i64[P] (masked_plane_popcounts). Returns a
// cudaError_t value.
int knox_masked_plane_popcounts(const void* planes, int width,
                                long long plane_stride, long long pack_stride,
                                const void* mask, void* pcnt, void* cnt,
                                int P, int W, void* stream) {
    SplitGeom g;
    if (width < 0 || width > KNOX_MAX_WIDTH || plane_stride < 0
        || pack_stride < 0 || P <= 0 || W <= 0
        || !split_geom(W, plane_stride % 4 == 0 && pack_stride % 4 == 0
                              && aligned16(planes) && aligned16(mask), &g))
        return (int)cudaErrorInvalidValue;
    return KNOX_LAUNCH_SPLIT(
        masked_popcounts_kernel, P, g, (cudaStream_t)stream,
        (const uint32_t*)planes, width, (size_t)plane_stride,
        (size_t)pack_stride, (const uint32_t*)mask, (long long*)pcnt,
        (long long*)cnt, W, g.q);
}
}  // extern "C"
