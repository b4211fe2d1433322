// Per-column bitonic sort of (u32 key, u32 payload) tiles, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of probes/msort_probe.py: `call` (:138),
// kernel `kern_sort` (:127), compare-exchange `exchange` (:102), stage list
// `col_sort_stages` (:66) -> knox_tile_bitonic_sort.
//
// Contract: keys and payloads are u32[N], N = B * 65,536, read as B tiles
// of [R = 512 rows, C = 128 columns], row-major. For every tile b and
// column c, the 512 pairs (key[b, :, c], pay[b, :, c]) run the probe's
// network exactly: stages (k, d) for k = 2, 4, ..., 512 and d = k/2, ..., 1;
// the element pair is (a, a + d) for every a with (a / d) even; it sorts
// ascending iff (a / k) is even; it swaps iff key[a] > key[a+d] (ascending)
// or key[a] < key[a+d] (descending), compared unsigned, so equal keys never
// swap and tied payloads land where the network puts them. Then the tile
// goes through `ntpose` transpose-and-reshapes of [512, 128] (the probe's
// in-kernel transposes): the element at flat tile position s = row * C +
// col moves to (s % C) * R + s / C, applied ntpose times; here that is an
// index permutation on the store.
//
// Design: one block per (tile, slab of 32 columns), 512 threads; the slab
// (512 rows x 32 columns x 2 words = 128 KB) sits in dynamic shared memory
// for all 45 stages, with one __syncthreads() per stage. Loads and stores
// move 128-byte row segments (a warp = one row of the slab). In a stage,
// thread t takes column t % 32 and the pairs (t / 32) + 16 j, j < 16: a
// warp reads 32 consecutive words of one row, so no shared-memory bank
// conflicts.
//
// What bounds it on the H100: shared-memory traffic, ~4 word reads and up
// to 4 word writes per compare-exchange, 45 stages x 8,192 exchanges per
// block; device memory is read and written once (8 B per element each
// way). 128 KB per block allows one block per SM (16 warps).

#include <cuda_runtime.h>
#include <stdint.h>

#define KNOX_SORT_R 512
#define KNOX_SORT_C 128
#define KNOX_SORT_SLAB 32
#define KNOX_SORT_THREADS 512
#define KNOX_SORT_SMEM (2 * KNOX_SORT_R * KNOX_SORT_SLAB * 4)

__global__ void __launch_bounds__(KNOX_SORT_THREADS)
tile_bitonic_sort_kernel(const uint32_t* __restrict__ keys,
                         const uint32_t* __restrict__ pay,
                         uint32_t* __restrict__ keys_out,
                         uint32_t* __restrict__ pay_out, int ntpose) {
    extern __shared__ uint32_t smem[];
    uint32_t* sk = smem;                                // [R][SLAB]
    uint32_t* sp = smem + KNOX_SORT_R * KNOX_SORT_SLAB;  // [R][SLAB]
    constexpr int SLABS = KNOX_SORT_C / KNOX_SORT_SLAB;
    const int tile = blockIdx.x / SLABS;
    const int col0 = (blockIdx.x % SLABS) * KNOX_SORT_SLAB;
    const long long base = (long long)tile * KNOX_SORT_R * KNOX_SORT_C;
    const int lane = threadIdx.x % KNOX_SORT_SLAB;
    const int row0 = threadIdx.x / KNOX_SORT_SLAB;      // 0..15
    constexpr int ROW_STEP = KNOX_SORT_THREADS / KNOX_SORT_SLAB;

    for (int r = row0; r < KNOX_SORT_R; r += ROW_STEP) {
        const long long g = base + (long long)r * KNOX_SORT_C + col0 + lane;
        sk[r * KNOX_SORT_SLAB + lane] = __ldg(keys + g);
        sp[r * KNOX_SORT_SLAB + lane] = __ldg(pay + g);
    }

    for (int k = 2; k <= KNOX_SORT_R; k <<= 1) {
        for (int d = k >> 1; d >= 1; d >>= 1) {
            __syncthreads();
            // 256 pairs per column; this thread's pairs are row0 + 16 j
            for (int pid = row0; pid < KNOX_SORT_R / 2; pid += ROW_STEP) {
                const int a = (pid / d) * 2 * d + (pid % d);
                const int b = a + d;
                const bool asc = ((a / k) & 1) == 0;
                const int ia = a * KNOX_SORT_SLAB + lane;
                const int ib = b * KNOX_SORT_SLAB + lane;
                const uint32_t ka = sk[ia], kb = sk[ib];
                if (asc ? (ka > kb) : (ka < kb)) {
                    const uint32_t pa = sp[ia], pb = sp[ib];
                    sk[ia] = kb;
                    sk[ib] = ka;
                    sp[ia] = pb;
                    sp[ib] = pa;
                }
            }
        }
    }
    __syncthreads();

    for (int r = row0; r < KNOX_SORT_R; r += ROW_STEP) {
        int s = r * KNOX_SORT_C + col0 + lane;          // flat tile position
        for (int t = 0; t < ntpose; ++t)
            s = (s % KNOX_SORT_C) * KNOX_SORT_R + s / KNOX_SORT_C;
        keys_out[base + s] = sk[r * KNOX_SORT_SLAB + lane];
        pay_out[base + s] = sp[r * KNOX_SORT_SLAB + lane];
    }
}

extern "C" {

// Sorts every 512-row column of the n / 65,536 tiles of (keys, pay) into
// (keys_out, pay_out), then applies ntpose transpose-and-reshapes per tile.
// n must be a positive multiple of 65,536. Returns a cudaError_t value.
int knox_tile_bitonic_sort(const void* keys, const void* pay, void* keys_out,
                           void* pay_out, int n, int ntpose, void* stream) {
    const int tile = KNOX_SORT_R * KNOX_SORT_C;
    if (n <= 0 || n % tile || ntpose < 0) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        tile_bitonic_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        KNOX_SORT_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (n / tile) * (KNOX_SORT_C / KNOX_SORT_SLAB);
    tile_bitonic_sort_kernel<<<blocks, KNOX_SORT_THREADS, KNOX_SORT_SMEM,
                               (cudaStream_t)stream>>>(
        (const uint32_t*)keys, (const uint32_t*)pay, (uint32_t*)keys_out,
        (uint32_t*)pay_out, ntpose);
    return (int)cudaGetLastError();
}

}  // extern "C"
