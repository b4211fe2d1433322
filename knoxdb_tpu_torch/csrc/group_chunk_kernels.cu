// Per-block byte-chunk group partials, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the group probes, which are all one
// function at different geometries, tile heights, output types and column
// layouts:
//   probes/pg3_variants.py  k_v1, k_v2, k_v3, make_call(S, vec)
//       H = 128, L = 8, C = 4; f32 (k_v2: i32) out; S = 8, 16, 32
//   probes/pg_bigG.py       k_loop, k_vec (interleaved), k_chunk (band)
//       H = 256, L = 32, C = 6; f32 out; S = 8; 8 passes reach G = 65,536
// Their loop-against-broadcast builds of the one-hot operand and their
// bf16-against-i8 operands are schedules of the TPU's matrix unit for this
// same function and have no counterpart here.
//
// Contract: rows are cut into blocks of `rows_per_block` (= S * 1024) rows.
// With h = gid >> shift (arithmetic), l = gid & (L - 1), NC = C + 1 and
// byte_c(row) = byte c of vlo (c < 4) or byte c - 4 of vhi:
//   out[b, h, l * NC + c] = Σ byte_c(row)   over rows of block b in (h, l)
//   out[b, h, l * NC + C] = number of those rows
// (band layout: column c * L + l instead of l * NC + c). A row whose h lies
// outside [0, H) contributes nothing: that is how a sentinel gid, and a gid
// below the current pass of a multi-pass caller (negative after gid - p *
// H * L), drop out. Every entry is at most 255 * rows_per_block <= 8,355,840
// at S = 32, which int32 holds and float32 represents exactly.
//
// Design: one thread block per output block. The whole [H, L * NC]
// histogram of the block lives in shared memory as int32 and is filled with
// shared-memory atomics (a zero byte adds nothing and is skipped); then the
// block writes it out once, converted where float32 is asked for. At H =
// 256, L = 32, NC = 7 the histogram is 229,376 bytes, over the 48 KB static
// limit and 3,072 bytes under the 232,448 an sm_90 block may opt into, so
// the kernel takes dynamic shared memory and raises its limit with
// cudaFuncSetAttribute; such a launch runs one block per SM and keeps
// nothing else in shared memory. A histogram that does not fit is refused
// (cudaErrorInvalidValue). The other sound choice, a loop over the NC
// column bands with the row tile held in registers, reads the rows once
// too but needs NC passes over them in the block; the whole histogram is
// the simpler kernel and was taken.
//
// What bounds it on the H100: bytes. It reads 12 B per row and writes H *
// L * NC * 4 B per block, which at H = 256, L = 32 is 28 B per row at S = 8:
// the partials, not the rows, are most of its traffic.

#include <cuda_runtime.h>
#include <stdint.h>

#define KNOX_CHUNK_THREADS 1024
#define KNOX_CHUNK_MAX_SMEM 232448

template <typename OutT>
__global__ void __launch_bounds__(KNOX_CHUNK_THREADS)
group_chunk_kernel(const int32_t* __restrict__ gid,
                   const uint32_t* __restrict__ vlo,
                   const uint32_t* __restrict__ vhi, OutT* __restrict__ out,
                   int n, int rows_per_block, int H, int L, int shift, int C,
                   int band) {
    extern __shared__ int hist[];                   // [H, L * NC]
    const int NC = C + 1;
    const int cells = H * L * NC;
    for (int j = threadIdx.x; j < cells; j += blockDim.x) hist[j] = 0;
    __syncthreads();

    const long long first = (long long)blockIdx.x * rows_per_block;
    long long last = first + rows_per_block;
    if (last > n) last = n;
    const int cstride = band ? L : 1;
    for (long long i = first + threadIdx.x; i < last; i += blockDim.x) {
        const int g = __ldg(gid + i);
        const int h = g >> shift;
        if ((unsigned)h >= (unsigned)H) continue;
        const int l = g & (L - 1);
        int* cell = hist + h * (L * NC) + (band ? l : l * NC);
        const uint32_t lo = __ldg(vlo + i);
        const uint32_t hi = __ldg(vhi + i);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            if (c < C) {
                const int b = (int)(((c < 4 ? lo : hi) >> (8 * (c & 3))) & 0xFFu);
                if (b) atomicAdd(cell + c * cstride, b);
            }
        }
        atomicAdd(cell + C * cstride, 1);
    }
    __syncthreads();

    OutT* dst = out + (long long)blockIdx.x * cells;
    for (int j = threadIdx.x; j < cells; j += blockDim.x)
        dst[j] = (OutT)hist[j];
}

template <typename OutT>
static cudaError_t launch(const int32_t* gid, const uint32_t* vlo,
                          const uint32_t* vhi, void* out, int n,
                          int rows_per_block, int H, int L, int shift, int C,
                          int band, cudaStream_t stream) {
    const size_t smem = sizeof(int) * (size_t)H * L * (C + 1);
    if (smem > KNOX_CHUNK_MAX_SMEM) return cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            group_chunk_kernel<OutT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const int blocks = (int)(((long long)n + rows_per_block - 1) / rows_per_block);
    group_chunk_kernel<OutT><<<blocks, KNOX_CHUNK_THREADS, smem, stream>>>(
        gid, vlo, vhi, (OutT*)out, n, rows_per_block, H, L, shift, C, band);
    return cudaGetLastError();
}

extern "C" {

// Per-block byte-chunk partials of n rows into out[ceil(n /
// rows_per_block), H, L * (C + 1)], float32 (out_f32 != 0) or int32, in the
// interleaved (band == 0) or band layout. Returns a cudaError_t value.
int knox_group_chunk_partials(const void* gid, const void* vlo,
                              const void* vhi, void* out, int n,
                              int rows_per_block, int H, int L, int shift,
                              int C, int out_f32, int band, void* stream) {
    if (n < 0 || rows_per_block <= 0 || H <= 0 || L <= 0 || (L & (L - 1))
            || shift < 0 || shift > 30 || C < 0 || C > 8)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t* g = (const int32_t*)gid;
    const uint32_t* lo = (const uint32_t*)vlo;
    const uint32_t* hi = (const uint32_t*)vhi;
    return (int)(out_f32
        ? launch<float>(g, lo, hi, out, n, rows_per_block, H, L, shift, C,
                        band, s)
        : launch<int>(g, lo, hi, out, n, rows_per_block, H, L, shift, C,
                      band, s));
}

}  // extern "C"
