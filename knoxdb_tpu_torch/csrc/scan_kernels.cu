// Fused bit-sliced scan kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of knoxdb_tpu/ops/pallas_scan.py:
//   _kernel_masked (fused_range_sum_masked) -> knox_fused_range_sum_masked
//   _kernel_tree   (fused_tree_agg)         -> knox_fused_tree_agg
// Both host entry points launch the one __global__ kernel below; the
// single-leaf entry is the tree kernel with one leaf and one sum spec.
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
// First target for a later perf PR: the aggregate passes re-read the
// planes from L2/HBM after the ladder, where the TPU kernel kept the
// pack's planes resident in VMEM; with one block per pack and 256
// threads, only 256 blocks cover the 132 SMs at the benchmark's size.
//
// Integer reductions: per-thread __popc, a warp __reduce_add_sync, then
// integer atomics in shared memory, so every result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#define KNOX_MAX_FIELDS 8
#define KNOX_MAX_LEAVES 8
#define KNOX_MAX_SPECS 8
#define KNOX_MAX_WIDTH 64
#define KNOX_NFLAGS 8
#define KNOX_MM_COLS 8
#define KNOX_MAX_THREADS 256

// flag word columns, as written by range_consts (ops/scan_kernels.py)
#define F_LO_LT_ALL 0
#define F_LO_GE_NONE 1
#define F_HI_IN 2
#define F_HI_GE_NONE 3
#define F_HI_LT_ALL 4

struct TreeParams {
    const uint32_t* planes[KNOX_MAX_FIELDS];   // [w_f, P, W] per field
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

template <int WPT>
__global__ void __launch_bounds__(KNOX_MAX_THREADS)
fused_tree_kernel(const TreeParams prm) {
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;
    const int W = prm.W;
    const size_t PW = (size_t)prm.P * W;
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
        const uint32_t* lob = prm.lo_bits[l] + cbase;
        const uint32_t* hib = prm.hi_bits[l] + cbase;
        const uint32_t* pl = prm.planes[f] + base;
        uint32_t lt_lo[WPT], eq_lo[WPT], lt_hi[WPT], eq_hi[WPT];
#pragma unroll
        for (int k = 0; k < WPT; ++k) {
            lt_lo[k] = 0u; eq_lo[k] = ~0u; lt_hi[k] = 0u; eq_hi[k] = ~0u;
        }
        for (int p = w - 1; p >= 0; --p) {
            const uint32_t cl = __ldg(lob + p);
            const uint32_t ch = __ldg(hib + p);
            const uint32_t* row = pl + (size_t)p * PW;
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
        const uint32_t* fl = prm.flags[l] + (size_t)blockIdx.x * KNOX_NFLAGS;
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
        const uint32_t* pl = prm.planes[f] + base;
        if (prm.pcnt[s]) {
            for (int i = tid; i < KNOX_MAX_WIDTH; i += nthr) s_acc[i] = 0;
            __syncthreads();
            for (int p = 0; p < w; ++p) {
                const uint32_t* row = pl + (size_t)p * PW;
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
                const uint32_t* row = pl + (size_t)p * PW;
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

static int launch(const TreeParams& prm, cudaStream_t stream) {
    if (prm.P <= 0 || prm.W <= 0 || prm.nleaf < 0 || prm.nleaf > KNOX_MAX_LEAVES
        || prm.nspec < 0 || prm.nspec > KNOX_MAX_SPECS)
        return (int)cudaErrorInvalidValue;
    // threads: one per word up to 256 (at least one warp); WPT words each
    int nthr = prm.W < KNOX_MAX_THREADS ? prm.W : KNOX_MAX_THREADS;
    if (nthr < 32) nthr = 32;
    nthr = (nthr + 31) / 32 * 32;
    const int wpt = (prm.W + nthr - 1) / nthr;
    if (wpt <= 1) fused_tree_kernel<1><<<prm.P, nthr, 0, stream>>>(prm);
    else if (wpt <= 2) fused_tree_kernel<2><<<prm.P, nthr, 0, stream>>>(prm);
    else if (wpt <= 4) fused_tree_kernel<4><<<prm.P, nthr, 0, stream>>>(prm);
    else if (wpt <= 8) fused_tree_kernel<8><<<prm.P, nthr, 0, stream>>>(prm);
    else if (wpt <= 16) fused_tree_kernel<16><<<prm.P, nthr, 0, stream>>>(prm);
    else return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

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
// masked popcounts (fused_range_sum_masked). Returns a cudaError_t value.
int knox_fused_range_sum_masked(const void* planes, int width,
                                const void* lo_bits, const void* hi_bits,
                                const void* flags, const void* mask_in,
                                void* mask_out, void* pcnt, void* cnt, int P,
                                int W, void* stream) {
    if (width < 0 || width > KNOX_MAX_WIDTH) return (int)cudaErrorInvalidValue;
    TreeParams prm = {};
    prm.planes[0] = (const uint32_t*)planes;
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

}  // extern "C"
