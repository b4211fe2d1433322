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
// col moves to (s % C) * R + s / C, which rotates the 16 bits of s left by
// 9; ntpose of them rotate by m = 9 * ntpose mod 16.
//
// What bounds it on the H100: device memory, each element read once and
// written once (16 B per (key, payload) pair). The compare-exchanges are
// 45 stages x 256 per column, and shared memory serves only the layout.
//
// Design: a CTA of 16 warps takes one slab of 16 columns of a tile; warp w
// sorts column w entirely in registers: lane l holds rows 16l .. 16l + 15
// (16 keys and 16 payloads).
//   - Load: the slab's rows arrive as 16-byte vectors (a warp reads 8 rows
//     of 64 bytes) into a column-major shared copy, 64 KB a CTA, two CTAs
//     an SM (32 warps). Each 4-row chunk of a column is XOR-swizzled by
//     its chunk and column bits, so the row-wise scalar writes and the
//     column-wise 16-byte reads are both free of bank conflicts.
//   - Sort: the 30 stages with d < 16 are compare-exchanges between a
//     lane's own registers, the 15 with d >= 16 are __shfl_xor_sync at
//     lane distance d / 16 (each lane keeps the min or the max by its
//     side, the same decision on both lanes). Within a merge phase the
//     keys of its descending blocks are held complemented, so every
//     compare-exchange is an unsigned min / max. No barrier and no
//     shared-memory traffic lies between the load and the store.
//   - Store: the sorted columns go back to the shared copy; then thread u
//     takes the u-th output position s' of the slab's image under the
//     rotation (the slab's 3 fixed column bits inserted into u at their
//     rotated places) and reads its source; where the image runs 4 words
//     or more (every ntpose but 3, 5, 10, 12 mod 16), 4 positions a
//     thread as one 16-byte store per array, so rows of the output leave
//     as whole lines.
//
// The first body (one 512-thread block per 32-column slab, 128 KB in
// shared memory for all 45 stages, a __syncthreads() and ~4 shared loads
// and stores per exchange, 32 sectors per warp store at odd ntpose) is in
// commit c5ef0bc; PERF.md has both times.

#include <cuda_runtime.h>
#include <stdint.h>

#define KNOX_SORT_R 512
#define KNOX_SORT_C 128
#define KNOX_SORT_COLS 16                       // columns (warps) per CTA
#define KNOX_SORT_THREADS (32 * KNOX_SORT_COLS)
#define KNOX_SORT_SLAB (KNOX_SORT_R * KNOX_SORT_COLS)   // words per array
#define KNOX_SORT_SMEM (2 * KNOX_SORT_SLAB * 4)
#define KNOX_SORT_BLOCKS_PER_SM 2                 // 32 warps, 64 registers

// The shared word of (column c, row r): 4-row chunk ch of column c at
// chunk ch ^ ((ch >> 3) & 3) ^ (2 * ((c >> 2) & 3)).
__device__ __forceinline__ int sort_sw(int c, int r) {
    const int ch = r >> 2;
    return c * KNOX_SORT_R
        + 4 * (ch ^ ((ch >> 3) & 3) ^ ((c >> 1) & 6)) + (r & 3);
}

// x with bit b inserted at position q (the bits from q up move up one).
__device__ __forceinline__ uint32_t insert_bit(uint32_t x, int q,
                                               uint32_t b) {
    const uint32_t low = (1u << q) - 1u;
    return ((x & ~low) << 1) | (b << q) | (x & low);
}

// The store of one slab: thread t takes E consecutive positions s' of the
// slab's image at a time (the image's u-th position is u with the fixed
// bits fb inserted at their places fq, in increasing order), reads each
// one's source s = s' rotated right by m, and writes them as one E-word
// store per array.
template <int E>
__device__ __forceinline__ void store_image(const uint32_t* sk,
                                            const uint32_t* sp,
                                            uint32_t* ko, uint32_t* po,
                                            int m, const int (&fq)[3],
                                            const uint32_t (&fb)[3]) {
    for (int u = E * threadIdx.x; u < KNOX_SORT_SLAB;
         u += E * KNOX_SORT_THREADS) {
        uint32_t s1 = (uint32_t)u;
#pragma unroll
        for (int i = 0; i < 3; ++i) s1 = insert_bit(s1, fq[i], fb[i]);
        uint32_t kv[E], pv[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
            const uint32_t x = s1 + e;
            const uint32_t s = ((x >> m) | (x << (16 - m))) & 0xFFFFu;
            const int w = sort_sw(s & (KNOX_SORT_COLS - 1), s >> 7);
            kv[e] = sk[w];
            pv[e] = sp[w];
        }
        if constexpr (E == 4) {
            *reinterpret_cast<uint4*>(ko + s1) =
                make_uint4(kv[0], kv[1], kv[2], kv[3]);
            *reinterpret_cast<uint4*>(po + s1) =
                make_uint4(pv[0], pv[1], pv[2], pv[3]);
        } else {
            ko[s1] = kv[0];
            po[s1] = pv[0];
        }
    }
}

__global__ void __launch_bounds__(KNOX_SORT_THREADS, KNOX_SORT_BLOCKS_PER_SM)
tile_bitonic_sort_kernel(const uint32_t* __restrict__ keys,
                         const uint32_t* __restrict__ pay,
                         uint32_t* __restrict__ keys_out,
                         uint32_t* __restrict__ pay_out, int ntpose) {
    extern __shared__ __align__(16) uint32_t smem[];
    uint32_t* sk = smem;
    uint32_t* sp = smem + KNOX_SORT_SLAB;
    constexpr int SLABS = KNOX_SORT_C / KNOX_SORT_COLS;
    const int slab = blockIdx.x % SLABS;
    const long long base =
        (long long)(blockIdx.x / SLABS) * KNOX_SORT_R * KNOX_SORT_C;
    const int t = threadIdx.x, lane = t & 31, col = t >> 5;

    // load: row r's 16 slab words as 4 vectors, into the column-major copy
    for (int i = t; i < KNOX_SORT_SLAB / 4; i += KNOX_SORT_THREADS) {
        const int r = i >> 2, c = 4 * (i & 3);
        const long long g = base + (long long)r * KNOX_SORT_C
            + slab * KNOX_SORT_COLS + c;
        const uint4 k4 = __ldg(reinterpret_cast<const uint4*>(keys + g));
        const uint4 p4 = __ldg(reinterpret_cast<const uint4*>(pay + g));
        sk[sort_sw(c, r)] = k4.x; sk[sort_sw(c + 1, r)] = k4.y;
        sk[sort_sw(c + 2, r)] = k4.z; sk[sort_sw(c + 3, r)] = k4.w;
        sp[sort_sw(c, r)] = p4.x; sp[sort_sw(c + 1, r)] = p4.y;
        sp[sort_sw(c + 2, r)] = p4.z; sp[sort_sw(c + 3, r)] = p4.w;
    }
    __syncthreads();

    uint32_t k[16], p[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int w = sort_sw(col, 16 * lane + 4 * q);
        const uint4 k4 = *reinterpret_cast<const uint4*>(sk + w);
        const uint4 p4 = *reinterpret_cast<const uint4*>(sp + w);
        k[4 * q] = k4.x; k[4 * q + 1] = k4.y;
        k[4 * q + 2] = k4.z; k[4 * q + 3] = k4.w;
        p[4 * q] = p4.x; p[4 * q + 1] = p4.y;
        p[4 * q + 2] = p4.z; p[4 * q + 3] = p4.w;
    }

    // the network: stage (k = 2^lk, d = 2^ld); row a = 16 * lane + i.
    // Through phase lk the keys of rows with bit lk of a set are held
    // complemented, so every stage sorts ascending: the unsigned compare
    // of two complements is the descending one, equal keys stay equal.
    auto dir = [&](int lk, int i) {
        return ((((lane << 4) | i) >> lk) & 1) ? 0xFFFFFFFFu : 0u;
    };
#pragma unroll
    for (int lk = 1; lk <= 9; ++lk) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
            k[i] ^= dir(lk, i) ^ (lk > 1 ? dir(lk - 1, i) : 0u);
#pragma unroll
        for (int ld = lk - 1; ld >= 0; --ld) {
            if (ld < 4) {
                const int d = 1 << ld;
#pragma unroll
                for (int i = 0; i < 16; ++i) {
                    if (i & d) continue;
                    const uint32_t ka = k[i], kb = k[i + d];
                    const uint32_t pa = p[i], pb = p[i + d];
                    const bool sw = ka > kb;
                    k[i] = min(ka, kb);
                    k[i + d] = max(ka, kb);
                    p[i] = sw ? pb : pa;
                    p[i + d] = sw ? pa : pb;
                }
            } else {
                // the pair's lower row sits in the lane whose bit m is
                // clear and keeps the min; the upper lane compares the
                // complements, so it keeps the max
                const int m = 1 << (ld - 4);
                const uint32_t flip = (lane & m) ? 0xFFFFFFFFu : 0u;
#pragma unroll
                for (int i = 0; i < 16; ++i) {
                    const uint32_t ok = __shfl_xor_sync(0xFFFFFFFFu, k[i], m);
                    const uint32_t op = __shfl_xor_sync(0xFFFFFFFFu, p[i], m);
                    const bool take = (ok ^ flip) < (k[i] ^ flip);
                    k[i] = take ? ok : k[i];
                    p[i] = take ? op : p[i];
                }
            }
        }
    }
    // no key is left complemented: bit 9 of a row below 512 is clear

#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int w = sort_sw(col, 16 * lane + 4 * q);
        *reinterpret_cast<uint4*>(sk + w) =
            make_uint4(k[4 * q], k[4 * q + 1], k[4 * q + 2], k[4 * q + 3]);
        *reinterpret_cast<uint4*>(sp + w) =
            make_uint4(p[4 * q], p[4 * q + 1], p[4 * q + 2], p[4 * q + 3]);
    }
    __syncthreads();

    // store: the slab's fixed bits 4-6 of s sit at (4 + m + i) mod 16 of
    // s'; u counts the image's positions in increasing order
    const int m = (9 * (ntpose & 15)) & 15;
    int fq[3];
    uint32_t fb[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        fq[i] = (4 + m + i) & 15;
        fb[i] = (slab >> i) & 1u;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2 - i; ++j)
            if (fq[j] > fq[j + 1]) {
                const int q = fq[j]; fq[j] = fq[j + 1]; fq[j + 1] = q;
                const uint32_t b = fb[j]; fb[j] = fb[j + 1]; fb[j + 1] = b;
            }
    if (fq[0] >= 2)                        // the image runs 4 words
        store_image<4>(sk, sp, keys_out + base, pay_out + base, m, fq, fb);
    else
        store_image<1>(sk, sp, keys_out + base, pay_out + base, m, fq, fb);
}

extern "C" {

// Sorts every 512-row column of the n / 65,536 tiles of (keys, pay) into
// (keys_out, pay_out), then applies ntpose transpose-and-reshapes per tile.
// n must be a positive multiple of 65,536 and every pointer 16-byte
// aligned. Returns a cudaError_t value.
int knox_tile_bitonic_sort(const void* keys, const void* pay, void* keys_out,
                           void* pay_out, int n, int ntpose, void* stream) {
    const int tile = KNOX_SORT_R * KNOX_SORT_C;
    if (n <= 0 || n % tile || ntpose < 0
        || (((uintptr_t)keys | (uintptr_t)pay | (uintptr_t)keys_out
             | (uintptr_t)pay_out) & 15))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        tile_bitonic_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        KNOX_SORT_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (n / tile) * (KNOX_SORT_C / KNOX_SORT_COLS);
    tile_bitonic_sort_kernel<<<blocks, KNOX_SORT_THREADS, KNOX_SORT_SMEM,
                               (cudaStream_t)stream>>>(
        (const uint32_t*)keys, (const uint32_t*)pay, (uint32_t*)keys_out,
        (uint32_t*)pay_out, ntpose);
    return (int)cudaGetLastError();
}

}  // extern "C"
