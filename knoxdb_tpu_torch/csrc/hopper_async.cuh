// Asynchronous copies into shared memory on NVIDIA Hopper (sm_90a):
// mbarriers and 1-D bulk copies (the TMA's non-tensor form), for the group
// kernel's ring.
//
// A ring stage is filled by one producer warp with warp_fill: every copy
// whose source address and size are multiples of 16 bytes goes by a bulk
// copy that completes a transaction count on the stage's "full" mbarrier;
// any other copy (the mask words of a ragged last chunk, a misaligned
// view) the warp's lanes move word by word before lane 0 arrives.
// Consumers wait on "full" with the stage's phase parity and, once the
// words they read are in use, release the stage with one arrival per warp
// on its "empty" mbarrier.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the mbarrier inits visible to the async proxy and the cluster;
// the thread that ran mbar_init calls it before the block's barrier.
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Spin until the barrier's phase with this parity has completed. A wait
// that lasts billions of cycles is a fault of the protocol: it traps, so
// the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_u32(bar);
    const long long t0 = clock64();
    uint32_t done;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done) : "r"(a), "r"(parity) : "memory");
        if (!done && clock64() - t0 > (1ll << 32)) __trap();
    } while (!done);
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

struct AsyncCopy {
    void* dst;          // shared memory, 16-byte aligned
    const void* src;    // global memory
    uint32_t bytes;     // a multiple of 4
};

__device__ __forceinline__ bool bulk_ok(const AsyncCopy& c) {
    return ((uintptr_t)c.src & 15) == 0 && (c.bytes & 15) == 0;
}

// The calling warp (all 32 lanes) fills one stage with N copies and
// arrives once on `full`, whose arrival count is 1.
template <int N>
__device__ __forceinline__ void warp_fill(const AsyncCopy (&c)[N],
                                          uint64_t* full) {
    const int lane = threadIdx.x & 31;
    uint32_t tx = 0;
    bool by_hand = false;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        if (bulk_ok(c[i])) {
            tx += c[i].bytes;
        } else {
            by_hand = true;
            uint32_t* d = static_cast<uint32_t*>(c[i].dst);
            const uint32_t* s = static_cast<const uint32_t*>(c[i].src);
            for (uint32_t j = lane; j < c[i].bytes / 4; j += 32) d[j] = __ldg(s + j);
        }
    }
    if (by_hand)   // order these generic writes before later bulk copies
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) {
        mbar_arrive_tx(full, tx);
#pragma unroll
        for (int i = 0; i < N; ++i)
            if (c[i].bytes && bulk_ok(c[i]))
                bulk_copy_g2s(c[i].dst, c[i].src, c[i].bytes, full);
    }
}
