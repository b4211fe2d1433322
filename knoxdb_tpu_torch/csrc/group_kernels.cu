// Exact per-group count and sums of u32 value words, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the two Pallas TPU kernels of knoxdb_tpu/ops/pallas_group.py:
//   _kernel         (fused_group_partials)         -> knox_group_sums, K = 1
//   _kernel_moments (fused_group_moments_partials) -> knox_group_sums, K = 2
// Both are the one entry below with K value pairs, which launches one of
// three templated __global__ bodies by G and K (LIMBS, CLUSTER, GLOBAL).
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
// LIMBS and CLUSTER take their rows the same way: a persistent grid walks
// the rows in chunks of 1024 (a block's j-th chunk is blockIdx + j *
// grid); each block is one producer warp and eight consumer warps. The
// producer keeps a ring of 2-5 stages full: one chunk's gid, value words
// and mask words arrive by 1-D bulk copies (TMA) on the stage's mbarrier.
// A consumer thread takes 4 rows of a stage as one 16-byte vector per
// column and the 4 mask bits from the chunk's mask word in shared memory.
// The form and the launch geometry come from
// ops/group_kernels.group_tile_plan.
//
//   - Small G, LIMBS (the histogram fits beside the ring in a block's
//     227 KB): at most two blocks per SM, each with its own histogram.
//     Each value word is split into 16-bit limbs, each summed in its own
//     u32 shared-memory counter; a block flushes its counters into the u64
//     output (one global atomicAdd per nonzero entry) every 64 chunks, so
//     a counter takes at most 65,536 limbs: 65,536 * 65,535 < 2^32.
//   - Large G, CLUSTER (past max_shared_groups(K): 9,136 groups for K = 1,
//     4,738 for K = 2): one histogram per thread block cluster of S = 8 or
//     16 CTAs (one CTA per SM), cut into S contiguous slices of `slice`
//     groups, one in each CTA's shared memory. No row adds into L2, and
//     none adds into another CTA's shared memory either: a body that did
//     (remote shared atomics, the carries' returning their old value)
//     lost to the GLOBAL loop (PERF.md). Instead the rows move: in
//     rounds of 1-4 chunks each CTA bins its passing rows by destination
//     rank into an outbox in its own shared memory (per rank a bucket
//     padded to 4 entries: the group's offset in its slice, then the
//     value words), and after a cluster barrier each CTA pulls its buckets
//     from every CTA of the cluster with 16-byte distributed shared memory
//     loads and adds them into its slice with plain shared atomics. The
//     counters are CARRY ones: one u32 count, and per value word one u32
//     sum and one u32 count of its wraps, read from the atomic's returned
//     old value (old + v < old); both stay below 2^31 for n < 2^31 rows,
//     so a CTA flushes its slice once, at the end, one global atomicAdd
//     per nonzero entry. The grid is as many clusters as
//     cudaOccupancyMaxActiveClusters reports.
//   - GLOBAL, where a CLUSTER round could hold only one chunk (K = 2
//     past 38,336 groups: the slice, two outboxes and the ring fill the
//     CTA) or 16 slices could not hold G: a grid-stride walk of 4 rows per
//     thread, at most four 256-thread blocks per SM, each passing row
//     adding to the u64 output in L2 directly. Atomics in L2 bound it
//     (about 12.5 M at config #3c); a round of one chunk lost to it at
//     every shape measured (PERF.md).
//
// What LIMBS replaced in the first body (64-bit shared atomicAdds, each a
// compare-and-swap loop in the SASS) is in PERF.md; the first body is in
// commit c5ef0bc.

#include <atomic>

#include <cooperative_groups.h>

#include "hopper_async.cuh"

namespace cg = cooperative_groups;

#define KNOX_GROUP_CONSUMERS 256
#define KNOX_GROUP_THREADS (KNOX_GROUP_CONSUMERS + 32)
#define KNOX_GROUP_CHUNK 1024              // rows per stage, 4 per consumer
#define KNOX_GROUP_MAX_STAGES 8
#define KNOX_GROUP_LIMB_CHUNKS 64          // 64 * 1024 * 65,535 < 2^32
#define KNOX_SMEM_MAX 232448               // a block's dynamic shared memory
#define KNOX_GROUP_MAX_CLUSTER 16          // non-portable past 8
#define KNOX_GLOBAL_THREADS 256
#define KNOX_GLOBAL_UNROLL 4
#define KNOX_GROUP_ROUND_CHUNKS 4          // CLUSTER: most chunks a round

enum { GROUP_GLOBAL = 0, GROUP_LIMBS = 1, GROUP_CLUSTER = 2 };

struct GroupParams {
    const int32_t* gid;          // [n]
    const uint32_t* mask;        // [n / 32]
    const uint32_t* vals[4];     // 2K value words, [n] each
    unsigned long long* out;     // [1 + 2K, G], zeroed by the caller
    long long n;
    int G;
    int stages;                  // ring stages
    // CLUSTER: slice groups per CTA, and ceil(2^32 / slice), so that
    // g / slice = (g * magic) >> 32
    int slice;
    unsigned long long magic;
    int round_chunks;            // CLUSTER: chunks of a round (1-4)
};

template <int NV>
__host__ __device__ constexpr int stage_bytes() {
    return KNOX_GROUP_CHUNK * 4 * (1 + NV) + KNOX_GROUP_CHUNK / 8;
}

__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;" :: "n"(KNOX_GROUP_CONSUMERS) : "memory");
}

// ---- the ring, shared by LIMBS and CLUSTER ----

struct Ring {
    uint64_t* full;
    uint64_t* empty;
    unsigned char* stages;
    int S;
};

// The ring at the start of dynamic shared memory; thread 0 initialises
// its mbarriers. Returns the first byte past it.
template <int NV>
__device__ __forceinline__ unsigned char* ring_init(unsigned char* smem,
                                                    int S, Ring& r) {
    r.full = reinterpret_cast<uint64_t*>(smem);
    r.empty = r.full + S;
    r.stages = smem + 16 * S;
    r.S = S;
    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(r.full + s, 1);
            mbar_init(r.empty + s, KNOX_GROUP_CONSUMERS / 32);
        }
        mbar_fence_init();
    }
    return r.stages + (size_t)S * stage_bytes<NV>();
}

// The producer warp: the block's i-th chunk c into ring stage i % S.
template <int NV>
__device__ __forceinline__ void fill_chunk(const GroupParams& p,
                                           const Ring& r, long long c,
                                           int i) {
    constexpr int R = KNOX_GROUP_CHUNK;
    const int s = i % r.S;
    if (i >= r.S) mbar_wait(r.empty + s, ((i / r.S) - 1) & 1);
    const long long r0 = c * R;
    const uint32_t rows = (uint32_t)min((long long)R, p.n - r0);
    unsigned char* st = r.stages + (size_t)s * stage_bytes<NV>();
    AsyncCopy cp[NV + 2];
    cp[0] = {st, p.gid + r0, rows * 4};
#pragma unroll
    for (int k = 0; k < NV; ++k)
        cp[1 + k] = {st + R * 4 * (1 + k), p.vals[k] + r0, rows * 4};
    cp[NV + 1] = {st + R * 4 * (1 + NV), p.mask + r0 / 32, rows / 8};
    warp_fill(cp, r.full + s);
}

// The producer warp: every chunk of this block into the ring.
template <int NV>
__device__ __forceinline__ void produce(const GroupParams& p, const Ring& r) {
    const long long nchunks = (p.n + KNOX_GROUP_CHUNK - 1) / KNOX_GROUP_CHUNK;
    int i = 0;
    for (long long c = blockIdx.x; c < nchunks; c += gridDim.x, ++i)
        fill_chunk<NV>(p, r, c, i);
}

// A consumer thread's 4 rows of one stage: gids, value words, mask bits.
template <int NV>
struct Quad {
    int g[4];
    uint32_t v[4][NV];
    uint32_t bits;
};

// Waits for stage i's chunk c and reads consumer thread t's 4 rows of it.
template <int NV>
__device__ __forceinline__ Quad<NV> consume(const GroupParams& p,
                                            const Ring& r, long long c,
                                            int i, int t) {
    constexpr int R = KNOX_GROUP_CHUNK;
    const int s = i % r.S;
    mbar_wait(r.full + s, (i / r.S) & 1);
    const int rows = (int)min((long long)R, p.n - c * R);
    const unsigned char* st = r.stages + (size_t)s * stage_bytes<NV>();
    Quad<NV> q = {};
    if (4 * t < rows) {                   // rows is a multiple of 32
        const int4 g4 = reinterpret_cast<const int4*>(st)[t];
        q.g[0] = g4.x; q.g[1] = g4.y; q.g[2] = g4.z; q.g[3] = g4.w;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            const uint4 x = reinterpret_cast<const uint4*>(
                st + R * 4 * (1 + k))[t];
            q.v[0][k] = x.x; q.v[1][k] = x.y; q.v[2][k] = x.z;
            q.v[3][k] = x.w;
        }
        const uint32_t mw = reinterpret_cast<const uint32_t*>(
            st + R * 4 * (1 + NV))[t >> 3];
        q.bits = (mw >> ((t & 7) * 4)) & 0xFu;
    }
    return q;
}

// Releases stage i once this warp's words are in use: an arrive issued
// right after the shared loads can overtake them (the SASS puts no wait
// between), and the refill then races the reads.
__device__ __forceinline__ void release(const Ring& r, int i) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + i % r.S);
}

// ---- LIMBS ----

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

template <int K>
__global__ void __launch_bounds__(KNOX_GROUP_THREADS)
group_sums_kernel(const GroupParams p) {
    constexpr int NV = 2 * K;
    extern __shared__ __align__(16) unsigned char smem[];
    Ring r;
    uint32_t* hist = reinterpret_cast<uint32_t*>(
        ring_init<NV>(smem, p.stages, r));
    const int G = p.G;
    for (int i = threadIdx.x; i < (1 + 2 * NV) * G; i += blockDim.x)
        hist[i] = 0u;
    __syncthreads();

    if (threadIdx.x < 32) {
        produce<NV>(p, r);
        return;
    }
    const int t = threadIdx.x - 32;               // consumer thread
    const long long nchunks = (p.n + KNOX_GROUP_CHUNK - 1) / KNOX_GROUP_CHUNK;
    int i = 0, since = 0;
    for (long long c = blockIdx.x; c < nchunks; c += gridDim.x, ++i) {
        const Quad<NV> q = consume<NV>(p, r, c, i, t);
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (((q.bits >> u) & 1u) && (unsigned)q.g[u] < (unsigned)G)
                add_row<NV>(hist, G, q.g[u], q.v[u]);
        release(r, i);
        if (++since == KNOX_GROUP_LIMB_CHUNKS) {
            flush<NV>(hist, p.out, G, t);
            since = 0;
        }
    }
    flush<NV>(hist, p.out, G, t);
}

// ---- CLUSTER ----

// The CLUSTER form's outbox entries for a round of rc chunks: every row,
// and each rank's bucket padded to a multiple of 4.
__host__ __device__ constexpr int cluster_box_entries(int rc) {
    return rc * KNOX_GROUP_CHUNK + 3 * KNOX_GROUP_MAX_CLUSTER;
}

// The CLUSTER form's shared memory past the ring, the slice and the two
// outboxes (each [1 + NV][cluster_box_entries] words: every passing row's
// group offset in its slice, then its value words, grouped by
// destination rank): each round's bucket (start, length) of every source
// ([2][MAX_CLUSTER] pairs), this round's bucket starts and counts.
__host__ __device__ constexpr int cluster_tail_bytes() {
    return 4 * 6 * KNOX_GROUP_MAX_CLUSTER;
}

// The slice's counters: count[slice], then per value word k sum_k[slice]
// and wrap_k[slice], each added by plain shared atomics of this CTA.
template <int NV>
__device__ __forceinline__ void add_carry(uint32_t* hist, int slice,
                                          uint32_t off,
                                          const uint32_t (&v)[NV]) {
    atomicAdd(hist + off, 1u);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        if (!v[k]) continue;
        uint32_t* a = hist + (size_t)(1 + 2 * k) * slice + off;
        const uint32_t old = atomicAdd(a, v[k]);
        if (old + v[k] < old) atomicAdd(a + slice, 1u);
    }
}

// Round i takes the block's chunks i * rc .. i * rc + rc - 1 (rc =
// round_chunks). Their passing rows are binned by destination rank into
// this CTA's outbox i % 2; each rank's bucket starts at a multiple of 4
// and is padded to one with entries that add nothing (offset ~0), and its
// start and length are stored into its destination CTA. After a cluster
// barrier every CTA pulls the buckets for its rank from every CTA of the
// cluster, 4 entries a step as one 16-byte distributed shared memory load
// per word, and adds them into its own slice. The outbox written in round
// i + 1 was drained by every CTA before that CTA arrived at barrier i.
template <int K>
__global__ void __launch_bounds__(KNOX_GROUP_THREADS, 1)
group_sums_cluster_kernel(const GroupParams p) {
    constexpr int NV = 2 * K, W = 1 + NV, RC = KNOX_GROUP_ROUND_CHUNKS;
    constexpr int MC = KNOX_GROUP_MAX_CLUSTER;
    constexpr uint32_t NONE = 0xFFFFFFFFu;
    extern __shared__ __align__(16) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const uint32_t me = cluster.block_rank();
    const int S = (int)cluster.num_blocks();
    Ring r;
    uint32_t* hist = reinterpret_cast<uint32_t*>(
        ring_init<NV>(smem, p.stages, r));
    const int slice = p.slice, rc = p.round_chunks;
    const int cap = cluster_box_entries(rc);
    uint32_t* box = hist + (size_t)(1 + 2 * NV) * slice;    // [2][W][cap]
    uint2* meta = reinterpret_cast<uint2*>(box + 2 * W * cap);  // [2][MC]
    uint32_t* start = reinterpret_cast<uint32_t*>(meta + 2 * MC);  // [MC]
    uint32_t* cnt = start + MC;                             // [MC]
    for (int i = threadIdx.x; i < (1 + 2 * NV) * slice; i += blockDim.x)
        hist[i] = 0u;
    if (threadIdx.x < MC) cnt[threadIdx.x] = 0u;
    cluster.sync();                  // every slice zeroed, every ring ready

    const long long nchunks = (p.n + KNOX_GROUP_CHUNK - 1) / KNOX_GROUP_CHUNK;
    const int mine = (int)((nchunks + gridDim.x - 1) / gridDim.x);
    const int rounds = (mine + rc - 1) / rc;
    const bool producer = threadIdx.x < 32;
    const int t = threadIdx.x - 32;
    const uint32_t G = (uint32_t)p.G;
    // the block's j-th chunk; the ring holds rc + 1 stages, so the chunks
    // of round i + 1 fill as round i's are released
    auto chunk = [&](int j) { return blockIdx.x + (long long)j * gridDim.x; };
    int next = 0;
    if (producer)
        for (; next < rc && chunk(next) < nchunks; ++next)
            fill_chunk<NV>(p, r, chunk(next), next);

    for (int i = 0; i < rounds; ++i) {
        uint32_t* out_b = box + (i & 1) * W * cap;
        uint2* meta_b = meta + (i & 1) * MC;
        if (producer) {
            for (; next < (i + 2) * rc && chunk(next) < nchunks; ++next)
                fill_chunk<NV>(p, r, chunk(next), next);
        } else {
            // each passing row's rank, and its slot in the rank's bucket
            Quad<NV> q[RC];
            uint32_t rank[RC][4], slot[RC][4];
#pragma unroll
            for (int cc = 0; cc < RC; ++cc) {
                const int j = i * rc + cc;
                q[cc] = Quad<NV>{};
                if (cc < rc && chunk(j) < nchunks)
                    q[cc] = consume<NV>(p, r, chunk(j), j, t);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const uint32_t gl = (uint32_t)q[cc].g[u];
                    const bool live = ((q[cc].bits >> u) & 1u) && gl < G;
                    rank[cc][u] = live
                        ? (uint32_t)(((unsigned long long)gl * p.magic) >> 32)
                        : NONE;
                    slot[cc][u] = live ? atomicAdd(cnt + rank[cc][u], 1u)
                                       : 0u;
                    q[cc].g[u] = (int)(gl - rank[cc][u] * (uint32_t)slice);
                }
            }
            consumers_sync();
            if (t < 32) {
                // lane t: rank t's bucket, padded to 4 entries, its start
                // by a warp scan, and its place stored into rank t
                const uint32_t c = t < S ? cnt[t] : 0u;
                const uint32_t pad = (c + 3u) & ~3u;
                uint32_t acc = pad;
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    const uint32_t x = __shfl_up_sync(0xFFFFFFFFu, acc, d);
                    if (t >= d) acc += x;
                }
                if (t < S) {
                    start[t] = acc - pad;
                    cnt[t] = 0u;
                    for (uint32_t e = acc - pad + c; e < acc; ++e)
                        out_b[e] = NONE;
                    *cluster.map_shared_rank(meta_b + me, t) =
                        make_uint2(acc - pad, pad);
                }
            }
            consumers_sync();
#pragma unroll
            for (int cc = 0; cc < RC; ++cc) {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    if (rank[cc][u] == NONE) continue;
                    const uint32_t e = start[rank[cc][u]] + slot[cc][u];
                    out_b[e] = (uint32_t)q[cc].g[u];
#pragma unroll
                    for (int k = 0; k < NV; ++k)
                        out_b[(1 + k) * cap + e] = q[cc].v[u][k];
                }
                const int j = i * rc + cc;
                if (cc < rc && chunk(j) < nchunks) release(r, j);
            }
        }
        cluster.sync();              // round i's outboxes are complete
        if (producer) continue;
        // the buckets for this rank, 4 entries a step: step qs lies in the
        // bucket of source s where pre_s <= qs < pre_s + len_s / 4
        uint32_t from[MC], pre[MC + 1];
        pre[0] = 0u;
#pragma unroll
        for (int s = 0; s < MC; ++s) {
            const uint2 m = s < S ? meta_b[s] : make_uint2(0u, 0u);
            from[s] = m.x;
            pre[s + 1] = pre[s] + m.y / 4;
        }
        for (uint32_t qs = t; qs < pre[MC]; qs += KNOX_GROUP_CONSUMERS) {
            int src = 0;
            uint32_t e = 0u;
#pragma unroll
            for (int s = 0; s < MC; ++s)
                if (qs >= pre[s] && qs < pre[s + 1]) {
                    src = s;
                    e = from[s] + 4 * (qs - pre[s]);
                }
            const uint32_t* in = cluster.map_shared_rank(out_b, src);
            uint4 x[W];
#pragma unroll
            for (int k = 0; k < W; ++k)
                x[k] = *reinterpret_cast<const uint4*>(in + k * cap + e);
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const uint32_t o = a == 0 ? x[0].x : a == 1 ? x[0].y
                                 : a == 2 ? x[0].z : x[0].w;
                if (o == NONE) continue;
                uint32_t v[NV];
#pragma unroll
                for (int k = 0; k < NV; ++k)
                    v[k] = a == 0 ? x[1 + k].x : a == 1 ? x[1 + k].y
                         : a == 2 ? x[1 + k].z : x[1 + k].w;
                add_carry<NV>(hist, slice, o, v);
            }
        }
    }
    // no CTA leaves while another still reads its outbox
    cluster.sync();
    const int lo = (int)me * slice;
    const int len = min(slice, p.G - lo);
    const size_t Gs = (size_t)p.G;
    for (int o = threadIdx.x; o < len; o += blockDim.x) {
        const size_t g = (size_t)lo + o;
        if (hist[o]) atomicAdd(p.out + g, (unsigned long long)hist[o]);
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            const uint32_t* a = hist + (size_t)(1 + 2 * k) * slice + o;
            const unsigned long long e = (unsigned long long)a[0]
                + ((unsigned long long)a[slice] << 32);
            if (e) atomicAdd(p.out + (1 + k) * Gs + g, e);
        }
    }
}

// ---- GLOBAL ----

// GLOBAL: a grid-stride walk, each thread loading UNROLL rows before it
// adds any into the u64 output in L2.
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

// ---- launches ----

template <int K>
static size_t ring_bytes(int stages) {
    return (16 + (size_t)stage_bytes<2 * K>()) * (size_t)stages;
}

template <int K>
static size_t cluster_smem(int stages, int slice, int round_chunks) {
    return ring_bytes<K>(stages)
        + sizeof(uint32_t) * (1 + 4 * K) * (size_t)slice
        + sizeof(uint32_t) * 2 * (1 + 2 * K)
              * (size_t)cluster_box_entries(round_chunks)
        + cluster_tail_bytes();
}

// Both shared-memory bodies may take a block's whole dynamic shared memory
// and the CLUSTER body clusters of up to 16 CTAs: set once per device (a bit
// each in `done`). The values are the same for every launch (a launch asks
// for its own size), so threads that launch at once cannot lower them under
// each other, and two that both set them set the same.
template <int K>
static cudaError_t set_attrs() {
    static std::atomic<unsigned> done{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    const unsigned bit = dev < 32 ? 1u << dev : 0u;
    if (err != cudaSuccess || (done.load() & bit)) return err;
    err = cudaFuncSetAttribute(
        group_sums_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        KNOX_SMEM_MAX);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            group_sums_cluster_kernel<K>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, KNOX_SMEM_MAX);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            group_sums_cluster_kernel<K>,
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) done.fetch_or(bit);
    return err;
}

static void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* at,
                           int S, int blocks, size_t smem,
                           cudaStream_t stream) {
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = (unsigned)S;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = dim3((unsigned)blocks, 1, 1);
    cfg.blockDim = dim3(KNOX_GROUP_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = at;
    cfg.numAttrs = 1;
}

template <int K>
static cudaError_t launch_cluster(const GroupParams& p, int S, int blocks,
                                  cudaStream_t stream) {
    const size_t smem = cluster_smem<K>(p.stages, p.slice, p.round_chunks);
    if (smem > KNOX_SMEM_MAX) return cudaErrorInvalidValue;
    cudaLaunchAttribute at[1];
    cudaLaunchConfig_t cfg;
    cluster_config(cfg, at, S, blocks, smem, stream);
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, group_sums_cluster_kernel<K>, p);
    return err != cudaSuccess ? err : cudaGetLastError();
}

template <int K>
static cudaError_t launch(const GroupParams& p, int mode, int blocks,
                          int cluster, cudaStream_t stream) {
    if (mode != GROUP_GLOBAL) {
        const cudaError_t err = set_attrs<K>();
        if (err != cudaSuccess) return err;
    }
    if (mode == GROUP_CLUSTER)
        return launch_cluster<K>(p, cluster, blocks, stream);
    if (mode == GROUP_GLOBAL) {
        group_sums_global_kernel<K>
            <<<blocks, KNOX_GLOBAL_THREADS, 0, stream>>>(p);
        return cudaGetLastError();
    }
    const size_t smem = ring_bytes<K>(p.stages)
        + sizeof(uint32_t) * (1 + 4 * K) * (size_t)p.G;
    if (smem > KNOX_SMEM_MAX) return cudaErrorInvalidValue;
    group_sums_kernel<K><<<blocks, KNOX_GROUP_THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <int K>
static int max_clusters(int S, int stages, int slice, int round_chunks) {
    const size_t smem = cluster_smem<K>(stages, slice, round_chunks);
    if (smem > KNOX_SMEM_MAX) return -(int)cudaErrorInvalidValue;
    cudaError_t err = set_attrs<K>();
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchAttribute at[1];
    cudaLaunchConfig_t cfg;
    cluster_config(cfg, at, S, S, smem, 0);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, group_sums_cluster_kernel<K>,
                                         &cfg);
    return err != cudaSuccess ? -(int)err : n;
}

extern "C" {

// Per-group count and sums of K = 1 (v0, v1) or K = 2 (v0..v3) u32 value
// pairs over n rows; out is a zeroed u64[1 + 2K, G]. The launch geometry
// comes from ops/group_kernels.group_tile_plan: mode 0 GLOBAL (blocks),
// 1 LIMBS (ring stages, blocks) or 2 CLUSTER (ring stages = round_chunks
// + 1, blocks = clusters * cluster CTAs, cluster size 2-16, slice groups
// per CTA (a multiple of 4) covering [0, G), chunks per round 1-4).
// Returns a cudaError_t value.
int knox_group_sums(const void* gid, const void* mask, const void* v0,
                    const void* v1, const void* v2, const void* v3, int K,
                    int n, int G, void* out, int mode, int stages,
                    int blocks, int cluster, int slice, int round_chunks,
                    void* stream) {
    if ((K != 1 && K != 2) || n < 0 || G < 0 || (n & 31) || blocks < 1
        || mode < GROUP_GLOBAL || mode > GROUP_CLUSTER
        || (mode != GROUP_GLOBAL
            && (stages < 2 || stages > KNOX_GROUP_MAX_STAGES)))
        return (int)cudaErrorInvalidValue;
    if (mode == GROUP_CLUSTER) {
        // the slices cover [0, G); g / slice is exact by the
        // multiply-shift for g * (magic * slice - 2^32) < 2^32
        const unsigned long long width =
            (unsigned long long)cluster * (unsigned long long)slice;
        if (cluster < 2 || cluster > KNOX_GROUP_MAX_CLUSTER || slice < 1
            || slice % 4
            || blocks % cluster || round_chunks < 1
            || round_chunks > KNOX_GROUP_ROUND_CHUNKS
            || stages != round_chunks + 1
            || width < (unsigned long long)G
            || width * (unsigned long long)slice >= (1ull << 32))
            return (int)cudaErrorInvalidValue;
    }
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
    p.slice = slice;
    p.magic = slice > 0 ? ((1ull << 32) + slice - 1) / slice : 0;
    p.round_chunks = round_chunks;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(K == 1 ? launch<1>(p, mode, blocks, cluster, s)
                        : launch<2>(p, mode, blocks, cluster, s));
}

// The most clusters of `cluster` CTAs of the CLUSTER form (K value pairs,
// slice groups per CTA, chunks per round) that the card holds at once,
// from cudaOccupancyMaxActiveClusters; a negative cudaError_t value on
// failure.
int knox_group_max_clusters(int K, int cluster, int slice,
                            int round_chunks) {
    if ((K != 1 && K != 2) || cluster < 2
        || cluster > KNOX_GROUP_MAX_CLUSTER || slice < 1 || round_chunks < 1
        || round_chunks > KNOX_GROUP_ROUND_CHUNKS)
        return -(int)cudaErrorInvalidValue;
    return K == 1 ? max_clusters<1>(cluster, round_chunks + 1, slice,
                                    round_chunks)
                  : max_clusters<2>(cluster, round_chunks + 1, slice,
                                    round_chunks);
}

}  // extern "C"
