// Point-Laplace P2P over near leaf pairs for Hopper (sm_90a).
//
// Replaces the TPU kernel fmm_bem_tpu/ops/p2p_tile.py::p2p_superblock_laplace.
// For every target leaf l and every source leaf s of its near list
//
//     pot[l, t]  += sum_j q[s, j] / r
//     f_d[l, t]  += sum_j q[s, j] (x_d[s, j] - x_d[l, t]) / r^3      d = 0..2
//
// with r = |x[s, j] - x[l, t]|; pairs with r^2 < eps2 contribute exactly 0
// (the self pair, and coincident points in different leaves).  Leaves are
// packed tiles xyzq [nl + 1, 4, K] (rows x, y, z, q); the result is
// [nl_t, 4, K] (rows pot, fx, fy, fz).  The real points of a leaf lead its
// tile and the count table cnt [nl + 1] (the closing dummy tile counts 0)
// says how many there are: only those are read, as sources and as targets.
// A count is clamped to [0, K] where it is read, so a table that does not
// fit the tiles cannot read past a tile or stall the segment plan.
//
// What bounds it on this card: operations.  The needed work is
// n_t x n_s evaluations per near pair, 18 flops and one reciprocal square
// root each; a leaf's points are 16 n bytes, served many times from L2.
// In practice the f32 instruction rate bounds it: about 16 instructions
// per evaluation, one 16-byte shared-memory load for every two.
//
// Design.  The pair list is sorted by target leaf and a row pointer gives
// each leaf its range: one block owns one target leaf (and one tile of up
// to BLOCK targets of it).  The block's threads are TX x G with TX half
// the leaf's real target count, so a leaf of 30 keeps 255 of 256 threads
// busy: thread (t, g) keeps targets t and t + TX (coordinates and the four
// partial sums of each) in registers and reuses every staged source for
// both.  At the start the block reads its pairs' source leaves and counts
// into shared memory (a window of WIN pairs).  The real source points of
// the leaf's pairs are staged, compacted, in segments of at most cap
// points (whole pairs, planned by a warp scan over the counts) as
// (x, y, z, q) vectors; group g takes the segment's points g, g + G, ...
// Segments are copied with cp.async into two stages, the next one while
// the current one is computed; a warp copies the pairs w, w + 8, ..., a
// lane the four components of one real point.  Five blocks share an SM
// (48 registers a thread at f32); cap is sized from the shared-memory
// budget that leaves each, and is at least K (a segment takes whole
// pairs).  The G partial sums are added in a fixed order through shared
// memory and stored once: no atomics, the same bits on every run; padded
// target slots and leaves without pairs get exact 0.
//
// Limits: K up to what two stages of K points fit in 227 KB (7,200 at
// f32, 3,584 at f64); tiles of more than BLOCK targets go to further
// blocks (grid.y); any number of pairs per leaf (the window slides).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;  // threads per block
constexpr int WIN = 256;    // pairs of the block's pair window
constexpr size_t SMEM_MAX = 227 * 1024;  // dynamic shared memory per block
constexpr int MIN_BLOCKS = 5;  // resident blocks per SM
// the stages' budget: MIN_BLOCKS blocks share an SM's 228 KB
constexpr size_t SMEM_BUDGET = 40 * 1024;

template <typename T>
struct alignas(16) Vec4 {
    T x, y, z, w;
};

// Taken of r^2 itself and kept only where r^2 >= eps2 = 1e-8, a normal
// float: there the flush-to-zero form gives rsqrtf's bits (and those of
// the plain version's floor max(r^2, eps2)) without its subnormal
// handling; below eps2 (r^2 = 0 gives inf) the caller selects 0.
__device__ __forceinline__ float inv_sqrt(float v) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
    return r;
}
__device__ __forceinline__ double inv_sqrt(double v) { return 1.0 / sqrt(v); }

// one element global -> shared, asynchronously
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async(double* dst, const double* src) {
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The next segment from pair pb: every warp computes it alike from the
// counts of up to 32 pairs (inclusive scan over the lanes), read from the
// block's pair window (psl, pcnt: pairs w0, w0 + 1, ...).  Returns the
// number of pairs it takes (at least 1: cap >= K); lane i gets pair
// pb + i's source leaf, count and offset in the segment, *n_seg the
// segment's points.
__device__ __forceinline__ int plan_segment(
        const int* psl, const int* pcnt, int w0, int pb, int p_end, int cap,
        int lane, int* sl, int* cnt, int* off, int* n_seg) {
    const int p = pb + lane;
    *sl = p < p_end ? psl[p - w0] : 0;
    *cnt = p < p_end ? pcnt[p - w0] : 0;
    int incl = *cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
    }
    *off = incl - *cnt;
    const unsigned fits = __ballot_sync(0xffffffffu, p < p_end && incl <= cap);
    const int np = __popc(fits);  // the scan is monotone: a prefix of lanes
    *n_seg = __shfl_sync(0xffffffffu, incl, np - 1);
    return np;
}

// Pairs [w0, w0 + WIN) of the leaf's range: source leaf and its count,
// clamped to [0, K] (an index outside the leaf table is an empty leaf).
__device__ __forceinline__ void load_window(
        const int* __restrict__ src_idx, const int* __restrict__ cnt,
        int nl_src, int K, int w0, int p_end, int* psl, int* pcnt) {
    for (int i = threadIdx.x; i < WIN && w0 + i < p_end; i += BLOCK) {
        const int sl = src_idx[w0 + i];
        const bool ok = sl >= 0 && sl < nl_src;
        psl[i] = ok ? sl : 0;
        pcnt[i] = ok ? min(max(cnt[sl], 0), K) : 0;
    }
}

// Copy the real points of pairs [pb, pb + np) into one stage, compacted
// as (x, y, z, q).  A warp takes a pair, a lane a real point of it and its
// four component rows: consecutive addresses in each row.
template <typename T>
__device__ __forceinline__ void stage_segment(
        const T* __restrict__ xyzq, Vec4<T>* stage, int np, int sl, int cnt,
        int off, int K) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int i = warp; i < np; i += BLOCK / 32) {
        const int sl_i = __shfl_sync(0xffffffffu, sl, i);
        const int n_i = __shfl_sync(0xffffffffu, cnt, i);
        const int o_i = __shfl_sync(0xffffffffu, off, i);
        T* dst = &stage[o_i].x;
        const T* src = xyzq + (int64_t)sl_i * 4 * K;
        for (int s = lane; s < n_i; s += 32) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
                cp_async(dst + 4 * s + c, src + c * K + s);
        }
    }
}

// One source v against a target (px, py, pz): its four partial sums.
template <typename T>
__device__ __forceinline__ void interact(const Vec4<T>& v, T px, T py, T pz,
                                         T eps2, T (&acc)[4]) {
    const T dx = v.x - px, dy = v.y - py, dz = v.z - pz;
    const T r2 = dx * dx + dy * dy + dz * dz;
    // excluded pairs give exactly 0, never 1 / eps2
    const T inv_r = r2 < eps2 ? T(0) : inv_sqrt(r2);
    const T qr = v.w * inv_r;
    const T w = qr * (inv_r * inv_r);
    acc[0] += qr;
    // difference form: sum_s w (s_d - t_d), per component
    acc[1] += w * dx;
    acc[2] += w * dy;
    acc[3] += w * dz;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
p2p_tile_kernel(const T* __restrict__ xyzq, const int* __restrict__ row_ptr,
                const int* __restrict__ src_idx, const int* __restrict__ cnt,
                T* __restrict__ out, int K, int nl_src, int cap, T eps2) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Vec4<T>* stage0 = reinterpret_cast<Vec4<T>*>(smem_raw);  // [2][cap]
    int* psl = reinterpret_cast<int*>(stage0 + 2 * cap);      // [WIN]
    int* pcnt = psl + WIN;                                     // [WIN]

    const int leaf = blockIdx.x;
    const int tile0 = blockIdx.y * BLOCK;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int n_here = min(max(min(cnt[leaf], K) - tile0, 0), BLOCK);
    const int p_begin = row_ptr[leaf];
    const int p_end = row_ptr[leaf + 1];
    T* orow = out + (int64_t)leaf * 4 * K + tile0;
    const bool out_live = tile0 + tid < K;

    if (n_here == 0 || p_begin == p_end) {  // exact zeros, no work
        if (out_live) {
#pragma unroll
            for (int c = 0; c < 4; ++c) orow[c * K + tid] = T(0);
        }
        return;
    }

    // thread (tx, g) of group g holds targets tx and tx + TX of this tile
    const int TX = (n_here + 1) / 2;
    const int G = BLOCK / TX;
    const int g = tid / TX;
    const int tx = tid - g * TX;
    const bool live = g < G;
    T a[3] = {T(0), T(0), T(0)}, b[3] = {T(0), T(0), T(0)};
    if (live) {
        const T* trow = xyzq + (int64_t)leaf * 4 * K + tile0;
        const int t_b = tx + TX < n_here ? tx + TX : tx;  // a lone target twice
        for (int d = 0; d < 3; ++d) {
            a[d] = trow[d * K + tx];
            b[d] = trow[d * K + t_b];
        }
    }
    T acc_a[4] = {T(0), T(0), T(0), T(0)}, acc_b[4] = {T(0), T(0), T(0), T(0)};

    int w0 = p_begin;
    load_window(src_idx, cnt, nl_src, K, w0, p_end, psl, pcnt);
    __syncthreads();
    int sl, n, off, n_cur, n_next = 0, np_next = 0;
    int pb = p_begin;
    int np = plan_segment(psl, pcnt, w0, pb, p_end, cap, lane, &sl, &n, &off,
                          &n_cur);
    stage_segment(xyzq, stage0, np, sl, n, off, K);
    cp_async_commit();
    pb += np;
    int buf = 0;
    while (true) {
        const bool more = pb < p_end;  // the same in every thread
        if (more) {
            if (pb - w0 + 32 > WIN && w0 + WIN < p_end) {
                __syncthreads();  // every warp has planned from the old one
                w0 = pb;          // slide the window
                load_window(src_idx, cnt, nl_src, K, w0, p_end, psl, pcnt);
                __syncthreads();
            }
            np_next = plan_segment(psl, pcnt, w0, pb, p_end, cap, lane, &sl,
                                   &n, &off, &n_next);
            stage_segment(xyzq, stage0 + (buf ^ 1) * cap, np_next, sl, n,
                          off, K);
        }
        cp_async_commit();
        cp_async_wait<1>();  // this thread's copies of the current stage
        __syncthreads();     // ... and everyone else's

        const Vec4<T>* src = stage0 + buf * cap;
        if (live) {
#pragma unroll 4
            for (int j = g; j < n_cur; j += G) {
                const Vec4<T> v = src[j];
                interact(v, a[0], a[1], a[2], eps2, acc_a);
                interact(v, b[0], b[1], b[2], eps2, acc_b);
            }
        }
        if (!more) break;
        __syncthreads();  // the stage is read out before it is refilled
        pb += np_next;
        n_cur = n_next;
        buf ^= 1;
    }

    // add the G groups' partial sums in a fixed order
    cp_async_wait<0>();
    __syncthreads();
    T* red = reinterpret_cast<T*>(smem_raw);  // [2 targets][4][BLOCK]
    if (live) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            red[c * BLOCK + g * TX + tx] = acc_a[c];
            red[(4 + c) * BLOCK + g * TX + tx] = acc_b[c];
        }
    }
    __syncthreads();
    if (out_live) {
        const bool real = tid < n_here;  // padded target slots are exactly 0
        const int h = tid < TX ? 0 : 4;
        const int t = tid < TX ? tid : tid - TX;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            T v = T(0);
            if (real) {
                const T* part = red + (h + c) * BLOCK + t;
                for (int gg = 0; gg < G; ++gg) v += part[gg * TX];
            }
            orow[c * K + tid] = v;
        }
    }
}

// Points a stage holds: as many as the budget gives, a multiple of 32,
// at least K (a segment takes whole pairs).
template <typename T>
int stage_cap(int K) {
    const size_t fit =
        (SMEM_BUDGET - 2 * WIN * sizeof(int)) / (2 * sizeof(Vec4<T>));
    const int cap = (int)(fit / 32 * 32);
    return cap > K ? cap : (K + 31) / 32 * 32;
}

template <typename T>
size_t smem_bytes(int cap) {
    const size_t stages = 2 * (size_t)cap * sizeof(Vec4<T>)
                          + 2 * WIN * sizeof(int);
    const size_t red = 8 * (size_t)BLOCK * sizeof(T);
    return stages > red ? stages : red;
}

template <typename T>
int launch(const void* xyzq, const void* row_ptr, const void* src_idx,
           const void* cnt, void* out, int nl_t, int K, int nl_src,
           double eps2, void* stream) {
    if (nl_t <= 0 || K <= 0) return (int)cudaSuccess;
    const int cap = stage_cap<T>(K);
    const size_t smem = smem_bytes<T>(cap);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            p2p_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(nl_t, (K + BLOCK - 1) / BLOCK);
    p2p_tile_kernel<T><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
        (const T*)xyzq, (const int*)row_ptr, (const int*)src_idx,
        (const int*)cnt, (T*)out, K, nl_src, cap, (T)eps2);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface.  All pointers are device pointers; the launch goes on
// the given stream, allocates nothing and does not synchronise.  Returns
// cudaGetLastError() (0 on success).
extern "C" int p2p_tile_f32(const void* xyzq, const void* row_ptr,
                            const void* src_idx, const void* cnt, void* out,
                            int nl_t, int K, int nl_src, double eps2,
                            void* stream) {
    return launch<float>(xyzq, row_ptr, src_idx, cnt, out, nl_t, K, nl_src,
                         eps2, stream);
}

extern "C" int p2p_tile_f64(const void* xyzq, const void* row_ptr,
                            const void* src_idx, const void* cnt, void* out,
                            int nl_t, int K, int nl_src, double eps2,
                            void* stream) {
    return launch<double>(xyzq, row_ptr, src_idx, cnt, out, nl_t, K, nl_src,
                          eps2, stream);
}

// Source points one stage holds at this K (f64 != 0: for the f64 kernel).
extern "C" int p2p_tile_stage_cap(int K, int f64) {
    return f64 ? stage_cap<double>(K) : stage_cap<float>(K);
}
