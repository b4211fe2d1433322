// Exact per-group count and sums of u32 value words, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the two Pallas TPU kernels of knoxdb_tpu/ops/pallas_group.py:
//   _kernel         (fused_group_partials)         -> knox_group_sums, K = 1
//   _kernel_moments (fused_group_moments_partials) -> knox_group_sums, K = 2
// Both are the one templated __global__ kernel below with K value pairs.
//
// Contract (the callers' one, not the TPU's per-tile f32 byte chunks):
// given gid int32[n], the packed row mask u32[n/32] (bit i%32 of word i/32
// is row i) and 2K value words u32[n], emit for every group g in [0, G)
//   out[0][g]     = #rows with mask bit set and gid == g
//   out[1+j][g]   = Σ vals[j][row] over those rows, j < 2K
// as u64 (int64 tensors on the Python side). Rows that are masked out or
// whose gid lies outside [0, G) contribute nothing (the reference's
// sentinel bin). Each sum is below n * 2^32 < 2^63 for n < 2^31 rows (the
// wrapper's limit), so it is exact; integer atomics commute, so results
// are deterministic and bit-exact whatever the order of the blocks.
//
// Design: a grid-stride loop over rows, about 4 blocks of 256 threads per
// SM, each thread loading UNROLL rows before it updates any group.
//   - Small G (G * (1 + 2K) * 8 bytes <= 48 KB): each block privatises the
//     whole histogram in shared memory (shared-memory atomicAdd) and flushes
//     each nonzero entry with one global atomicAdd at the end.
//   - Large G: rows update the output in global memory directly. Collisions
//     are rare at large G, and the 24-40 bytes per group of the output stay
//     in the 50 MB L2 up to G = 65,536. (The reference's multi-pass trick
//     over group ranges, groupby.py:712-717, is not needed.)
//
// What bounds it on the H100: bytes, 12 B/row for K = 1 (gid and two value
// words; the mask adds 1/8 B/row) and 20 B/row for K = 2, plus atomics
// contention when few groups take many rows (G = 1 serialises every update
// of a block on one shared-memory word; warp-level aggregation with
// __match_any_sync would cure that).
//
// First target for a later perf PR: fuse the bit-transpose decode of gid
// and of the values into this kernel, so the decoded [n] columns never go
// through device memory (they now cost a write and a read each).

#include <cuda_runtime.h>
#include <stdint.h>

#define KNOX_GROUP_THREADS 256
#define KNOX_GROUP_BLOCKS_PER_SM 4
#define KNOX_GROUP_UNROLL 4
#define KNOX_GROUP_SMEM_BUDGET (48 * 1024)

struct GroupParams {
    const int32_t* gid;          // [n]
    const uint32_t* mask;        // [n / 32]
    const uint32_t* vals[4];     // 2K value words, [n] each
    unsigned long long* out;     // [1 + 2K, G], zeroed by the caller
    long long n;
    int G;
};

template <int K, bool SHARED>
__global__ void __launch_bounds__(KNOX_GROUP_THREADS)
group_sums_kernel(const GroupParams p) {
    constexpr int R = 1 + 2 * K;
    extern __shared__ unsigned long long hist[];    // [R, G] when SHARED
    const int G = p.G;
    unsigned long long* acc = SHARED ? hist : p.out;
    if (SHARED) {
        for (int i = threadIdx.x; i < R * G; i += blockDim.x) hist[i] = 0ull;
        __syncthreads();
    }
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         base < p.n; base += stride * KNOX_GROUP_UNROLL) {
        int g[KNOX_GROUP_UNROLL];
        bool ok[KNOX_GROUP_UNROLL];
        uint32_t v[KNOX_GROUP_UNROLL][2 * K];
#pragma unroll
        for (int u = 0; u < KNOX_GROUP_UNROLL; ++u) {
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
        for (int u = 0; u < KNOX_GROUP_UNROLL; ++u) {
            if (!ok[u]) continue;
            atomicAdd(acc + g[u], 1ull);
#pragma unroll
            for (int k = 0; k < 2 * K; ++k)
                if (v[u][k])
                    atomicAdd(acc + (long long)(1 + k) * G + g[u],
                              (unsigned long long)v[u][k]);
        }
    }
    if (SHARED) {
        __syncthreads();
        for (int g = threadIdx.x; g < G; g += blockDim.x) {
            const unsigned long long c = hist[g];
            if (c == 0ull) continue;
            atomicAdd(p.out + g, c);
#pragma unroll
            for (int r = 1; r < R; ++r) {
                const unsigned long long s = hist[r * G + g];
                if (s) atomicAdd(p.out + (long long)r * G + g, s);
            }
        }
    }
}

template <int K>
static cudaError_t launch(const GroupParams& p, cudaStream_t stream) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const long long per_block = (long long)KNOX_GROUP_THREADS * KNOX_GROUP_UNROLL;
    long long blocks = (p.n + per_block - 1) / per_block;
    const long long cap = (long long)sms * KNOX_GROUP_BLOCKS_PER_SM;
    if (blocks > cap) blocks = cap;
    const size_t smem = sizeof(unsigned long long) * (1 + 2 * K) * (size_t)p.G;
    if (smem <= KNOX_GROUP_SMEM_BUDGET)
        group_sums_kernel<K, true>
            <<<(int)blocks, KNOX_GROUP_THREADS, smem, stream>>>(p);
    else
        group_sums_kernel<K, false>
            <<<(int)blocks, KNOX_GROUP_THREADS, 0, stream>>>(p);
    return cudaGetLastError();
}

extern "C" {

// Per-group count and sums of K = 1 (v0, v1) or K = 2 (v0..v3) u32 value
// pairs over n rows; out is a zeroed u64[1 + 2K, G]. Returns a cudaError_t
// value.
int knox_group_sums(const void* gid, const void* mask, const void* v0,
                    const void* v1, const void* v2, const void* v3, int K,
                    int n, int G, void* out, void* stream) {
    if ((K != 1 && K != 2) || n < 0 || G < 0 || (n & 31))
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
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(K == 1 ? launch<1>(p, s) : launch<2>(p, s));
}

}  // extern "C"
