// Exact per-group count and sums of u32 value words, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the two Pallas TPU kernels of knoxdb_tpu/ops/pallas_group.py:
//   _kernel         (fused_group_partials)         -> knox_group_sums, K = 1
//   _kernel_moments (fused_group_moments_partials) -> knox_group_sums, K = 2
// Both are the one entry below with K value pairs, which launches one of
// two templated __global__ bodies by G (LIMBS or GLOBAL, below).
//
// Contract (the callers' one, not the TPU's per-tile f32 byte chunks):
// given gid int32[n], the packed row mask u32[n/32] (bit i%32 of word i/32
// is row i) and 2K value words u32[n], emit for every group g in [0, G)
//   out[0][g]     = #rows with mask bit set and gid == g
//   out[1+j][g]   = Σ vals[j][row] over those rows, j < 2K
// as u64 (int64 tensors on the Python side). Rows that are masked out or
// whose gid lies outside [0, G) contribute nothing (the reference's
// sentinel bin). Each sum is below n * 2^32 < 2^63 for n < 2^31 rows (the
// wrapper's limit), so it is exact; integer additions commute, so results
// are deterministic and bit-exact whatever the order of the blocks.
//
// What bounds it on the H100: bytes, 12 B/row for K = 1 (gid and two value
// words; the mask adds 1/8 B/row) and 20 B/row for K = 2, over 3.35 TB/s.
//
// Design (the launch geometry comes from ops/group_kernels.group_tile_plan,
// and the form from G alone):
//   - Small G, LIMBS (the histogram fits beside the ring in a block's
//     227 KB): a persistent grid of at most two blocks per SM walks the
//     rows in chunks of 1024 (chunk c goes to block c % grid). Each block
//     is one producer warp and eight consumer warps. The producer keeps a
//     ring of 2-4 stages full: one chunk's gid, value words and mask words
//     arrive by 1-D bulk copies (TMA) on the stage's mbarrier, so 25-60 KiB
//     per block are in flight while the consumers add. A consumer thread
//     takes 4 rows of a stage as one 16-byte vector per column and the 4
//     mask bits from the chunk's mask word in shared memory. Each value
//     word is split into 16-bit limbs, each summed in its own u32
//     shared-memory counter; a block flushes its counters into the u64
//     output (one global atomicAdd per nonzero entry) every 64 chunks, so
//     a counter takes at most 65,536 limbs: 65,536 * 65,535 < 2^32.
//   - Large G, GLOBAL: a grid-stride walk of 4 rows per thread, at most
//     four 256-thread blocks per SM, each passing row adding to the u64
//     output in L2 directly (the 24-40 bytes per group stay in the 50 MB
//     L2 up to G = 65,536; the chunk kernel's multi-pass form loses 4.2x
//     there). Atomics in L2 bound it, not loads: the ring's vector loads
//     ran 3.8% slower here at config #3c (PERF.md), so this form keeps the
//     first body's loop.
//
// What LIMBS replaces in the first body (grid-stride scalar loads, 1 + 2K
// 64-bit shared atomicAdds per row, 528 blocks each flushing 3G u64
// atomics): the 64-bit shared atomics, each a compare-and-swap loop in the
// SASS, become native 32-bit ones; the scalar 4-byte loads and the per-row
// mask reload become bulk copies and 16-byte shared-memory vectors; the
// flush comes once per 65,536 rows of a block. A second 32-bit form, one
// u32 sum per word with a wrap counter read from the atomic's returned
// value, tied LIMBS at two blocks per SM and lost at one; commit e351633
// holds it.

#include "hopper_async.cuh"

#define KNOX_GROUP_CONSUMERS 256
#define KNOX_GROUP_THREADS (KNOX_GROUP_CONSUMERS + 32)
#define KNOX_GROUP_CHUNK 1024              // rows per stage, 4 per consumer
#define KNOX_GROUP_MAX_STAGES 8
#define KNOX_GROUP_LIMB_CHUNKS 64          // 64 * 1024 * 65,535 < 2^32
#define KNOX_SMEM_MAX 232448               // a block's dynamic shared memory
#define KNOX_GLOBAL_THREADS 256
#define KNOX_GLOBAL_UNROLL 4

enum { GROUP_GLOBAL = 0, GROUP_LIMBS = 1 };

struct GroupParams {
    const int32_t* gid;          // [n]
    const uint32_t* mask;        // [n / 32]
    const uint32_t* vals[4];     // 2K value words, [n] each
    unsigned long long* out;     // [1 + 2K, G], zeroed by the caller
    long long n;
    int G;
    int stages;                  // ring stages (LIMBS)
};

template <int NV>
__host__ __device__ constexpr int stage_bytes() {
    return KNOX_GROUP_CHUNK * 4 * (1 + NV) + KNOX_GROUP_CHUNK / 8;
}

__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;" :: "n"(KNOX_GROUP_CONSUMERS) : "memory");
}

// One passing row of group g with value words v[0..NV): the count and
// each word's two 16-bit limbs into the block's u32 counters.
template <int NV>
__device__ __forceinline__ void add_row(uint32_t* hist, int G, int g,
                                        const uint32_t (&v)[NV]) {
    atomicAdd(hist + g, 1u);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        uint32_t* a = hist + (size_t)(1 + 2 * k) * G + g;
        const uint32_t lo = v[k] & 0xFFFFu, hi = v[k] >> 16;
        if (lo) atomicAdd(a, lo);
        if (hi) atomicAdd(a + G, hi);
    }
}

// Adds the block's counters into the u64 output and zeroes them; every
// consumer thread calls it.
template <int NV>
__device__ __forceinline__ void flush(uint32_t* hist, unsigned long long* out,
                                      int G, int t) {
    consumers_sync();
    for (int g = t; g < G; g += KNOX_GROUP_CONSUMERS) {
        const uint32_t c = hist[g];
        if (!c) continue;
        hist[g] = 0u;
        atomicAdd(out + g, (unsigned long long)c);
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            uint32_t* a = hist + (size_t)(1 + 2 * k) * G + g;
            const unsigned long long s =
                (unsigned long long)a[0] + ((unsigned long long)a[G] << 16);
            a[0] = 0u;
            a[G] = 0u;
            if (s) atomicAdd(out + (size_t)(1 + k) * G + g, s);
        }
    }
    consumers_sync();
}

// LIMBS: the TMA ring and the 32-bit shared counters (small G).
template <int K>
__global__ void __launch_bounds__(KNOX_GROUP_THREADS)
group_sums_kernel(const GroupParams p) {
    constexpr int NV = 2 * K;
    constexpr int R = KNOX_GROUP_CHUNK;
    constexpr int SB = stage_bytes<NV>();
    extern __shared__ __align__(16) unsigned char smem[];
    const int S = p.stages, G = p.G;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + S;
    unsigned char* ring = smem + 16 * S;
    uint32_t* hist = reinterpret_cast<uint32_t*>(ring + (size_t)S * SB);
    const long long nchunks = (p.n + R - 1) / R;
    const int lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, KNOX_GROUP_CONSUMERS / 32);
        }
        mbar_fence_init();
    }
    for (int i = threadIdx.x; i < (1 + 2 * NV) * G; i += blockDim.x)
        hist[i] = 0u;
    __syncthreads();

    if (threadIdx.x < 32) {                       // the producer warp
        int i = 0;
        for (long long c = blockIdx.x; c < nchunks; c += gridDim.x, ++i) {
            const int s = i % S;
            if (i >= S) mbar_wait(empty + s, ((i / S) - 1) & 1);
            const long long r0 = c * R;
            const uint32_t rows = (uint32_t)min((long long)R, p.n - r0);
            unsigned char* st = ring + (size_t)s * SB;
            AsyncCopy cp[NV + 2];
            cp[0] = {st, p.gid + r0, rows * 4};
#pragma unroll
            for (int k = 0; k < NV; ++k)
                cp[1 + k] = {st + R * 4 * (1 + k), p.vals[k] + r0, rows * 4};
            cp[NV + 1] = {st + R * 4 * (1 + NV), p.mask + r0 / 32, rows / 8};
            warp_fill(cp, full + s);
        }
        return;
    }

    const int t = threadIdx.x - 32;               // consumer thread
    int i = 0, since = 0;
    for (long long c = blockIdx.x; c < nchunks; c += gridDim.x, ++i) {
        const int s = i % S;
        mbar_wait(full + s, (i / S) & 1);
        const int rows = (int)min((long long)R, p.n - c * R);
        const unsigned char* st = ring + (size_t)s * SB;
        int g[4] = {0, 0, 0, 0};
        uint32_t v[4][NV];
        uint32_t bits = 0u;
        if (4 * t < rows) {               // rows is a multiple of 32
            const int4 g4 = reinterpret_cast<const int4*>(st)[t];
            g[0] = g4.x; g[1] = g4.y; g[2] = g4.z; g[3] = g4.w;
#pragma unroll
            for (int k = 0; k < NV; ++k) {
                const uint4 x = reinterpret_cast<const uint4*>(
                    st + R * 4 * (1 + k))[t];
                v[0][k] = x.x; v[1][k] = x.y; v[2][k] = x.z; v[3][k] = x.w;
            }
            const uint32_t mw = reinterpret_cast<const uint32_t*>(
                st + R * 4 * (1 + NV))[t >> 3];
            bits = (mw >> ((t & 7) * 4)) & 0xFu;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (((bits >> u) & 1u) && (unsigned)g[u] < (unsigned)G)
                add_row<NV>(hist, G, g[u], v[u]);
        // release the stage only once its words are in use: an arrive
        // issued right after the shared loads can overtake them (the SASS
        // puts no wait between), and the refill then races the reads
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
        if (++since == KNOX_GROUP_LIMB_CHUNKS) {
            flush<NV>(hist, p.out, G, t);
            since = 0;
        }
    }
    flush<NV>(hist, p.out, G, t);
}

// GLOBAL: a grid-stride walk, each thread loading UNROLL rows before it
// adds any into the u64 output in L2 (large G).
template <int K>
__global__ void __launch_bounds__(KNOX_GLOBAL_THREADS)
group_sums_global_kernel(const GroupParams p) {
    const int G = p.G;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         base < p.n; base += stride * KNOX_GLOBAL_UNROLL) {
        int g[KNOX_GLOBAL_UNROLL];
        bool ok[KNOX_GLOBAL_UNROLL];
        uint32_t v[KNOX_GLOBAL_UNROLL][2 * K];
#pragma unroll
        for (int u = 0; u < KNOX_GLOBAL_UNROLL; ++u) {
            const long long i = base + u * stride;
            ok[u] = false;
            g[u] = 0;
            if (i < p.n) {
                g[u] = __ldg(p.gid + i);
                const uint32_t w = __ldg(p.mask + (i >> 5));
                ok[u] = ((w >> (i & 31)) & 1u) && (unsigned)g[u] < (unsigned)G;
            }
#pragma unroll
            for (int k = 0; k < 2 * K; ++k)
                v[u][k] = ok[u] ? __ldg(p.vals[k] + i) : 0u;
        }
#pragma unroll
        for (int u = 0; u < KNOX_GLOBAL_UNROLL; ++u) {
            if (!ok[u]) continue;
            atomicAdd(p.out + g[u], 1ull);
#pragma unroll
            for (int k = 0; k < 2 * K; ++k)
                if (v[u][k])
                    atomicAdd(p.out + (long long)(1 + k) * G + g[u],
                              (unsigned long long)v[u][k]);
        }
    }
}

template <int K>
static cudaError_t launch(const GroupParams& p, int mode, int blocks,
                          cudaStream_t stream) {
    if (mode == GROUP_GLOBAL) {
        group_sums_global_kernel<K>
            <<<blocks, KNOX_GLOBAL_THREADS, 0, stream>>>(p);
        return cudaGetLastError();
    }
    const size_t smem = 16 * (size_t)p.stages
        + (size_t)p.stages * stage_bytes<2 * K>()
        + sizeof(uint32_t) * (1 + 4 * K) * (size_t)p.G;
    if (smem > KNOX_SMEM_MAX) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        group_sums_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    group_sums_kernel<K><<<blocks, KNOX_GROUP_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

extern "C" {

// Per-group count and sums of K = 1 (v0, v1) or K = 2 (v0..v3) u32 value
// pairs over n rows; out is a zeroed u64[1 + 2K, G]. The launch geometry
// (mode 0 GLOBAL / 1 LIMBS, ring stages for LIMBS, blocks) comes from
// ops/group_kernels.group_tile_plan. Returns a cudaError_t value.
int knox_group_sums(const void* gid, const void* mask, const void* v0,
                    const void* v1, const void* v2, const void* v3, int K,
                    int n, int G, void* out, int mode, int stages,
                    int blocks, void* stream) {
    if ((K != 1 && K != 2) || n < 0 || G < 0 || (n & 31) || blocks < 1
        || (mode != GROUP_GLOBAL && mode != GROUP_LIMBS)
        || (mode == GROUP_LIMBS
            && (stages < 2 || stages > KNOX_GROUP_MAX_STAGES)))
        return (int)cudaErrorInvalidValue;
    if (n == 0 || G == 0) return (int)cudaSuccess;
    GroupParams p = {};
    p.gid = (const int32_t*)gid;
    p.mask = (const uint32_t*)mask;
    p.vals[0] = (const uint32_t*)v0;
    p.vals[1] = (const uint32_t*)v1;
    p.vals[2] = (const uint32_t*)v2;
    p.vals[3] = (const uint32_t*)v3;
    p.out = (unsigned long long*)out;
    p.n = n;
    p.G = G;
    p.stages = stages;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(K == 1 ? launch<1>(p, mode, blocks, s)
                        : launch<2>(p, mode, blocks, s));
}

}  // extern "C"
