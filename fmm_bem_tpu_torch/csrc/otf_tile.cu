// On-the-fly BEM near field over near leaf pairs for Hopper (sm_90a).
//
// Replaces the TPU kernel fmm_bem_tpu/ops/otf_tile.py::otf_superblock_bem.
// For every target leaf l and every source leaf s of its near list the
// regular KQ-point panel quadrature is recomputed and contracted with the
// source charges on the spot:
//
//     G [t, j] = sum_k w_k e^{-kappa r} / r
//     dG[t, j] = sum_k w_k (d . n_j) (kappa r + 1) e^{-kappa r} / r^3
//     out[l, t] += sum_j (bc[l, t] == 0 ? G : dG)[t, j] * q[s, j]
//
// with d = qp[s, j, k] - x[l, t], r = |d| (r^2 floored at 1e-30).  Source
// tiles [nl + 1, 4*KQ + 3, K] hold the quadrature points dim-major, the
// weights (times area) and the panel normal; target tiles [nl + 1, 4, K]
// hold x, y, z and the BC flag; charges are [nl_s, K].  The real panels
// of a leaf lead its tile and the count tables src_cnt / tgt_cnt
// [nl + 1] say how many there are: only those are read.  The kernel
// trusts neither table: each count is clamped to [0, K], and a source
// leaf index outside [0, nl_s) reads as an empty leaf.
//
// What bounds it on this card: operations.  The needed work is
// n_t x n_s x KQ kernel evaluations per near pair, 10 (G) to 18 (dG)
// flops and one reciprocal square root (plus one exponential when
// kappa > 0) each; the source tiles are a few KB, served many times from
// L2.  In practice f32 issue: about 12 instructions per evaluation.
//
// Design.  The pair list is sorted by target leaf and a row pointer gives
// each leaf its range: one block owns one target leaf (and one tile of up
// to BLOCK targets of it).  The block's threads are TX x G with TX half
// the leaf's real target count, so a half-full leaf keeps its threads
// busy: thread (t, g) keeps targets t and t + TX (coordinates, BC flags,
// partial sums) in registers and reuses every staged point for both.  At
// the start the block reads its pairs' source leaves and counts into
// shared memory (a window of WIN pairs).  The real source panels of the
// leaf's pairs are staged, compacted, in segments of at most cap panels
// (whole pairs; cap is 256, or fewer where two stages of a large KQ
// would not fit in shared memory), as (x, y, z, w) per quadrature point
// and (nx, ny, nz, q) per panel; group g takes the segment's panels g,
// g + G, ...  Segments are copied with cp.async into two stages, the
// next one while the current one is computed; a warp copies a component
// row of a pair, its lanes the row's real slots.  A thread takes the G
// or the dG branch of each target once per segment, not per evaluation.
// The zero weight stays the first factor of a product and r^2 keeps its
// floor.  The G partial sums are added in a fixed order through shared
// memory and stored once: no atomics, the same bits on every run; padded
// target slots and leaves without pairs get exact 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;     // threads per block
constexpr int CAP_MAX = 256;   // panels a stage holds, where they fit
constexpr int WIN = 256;       // pairs of the block's pair window
constexpr size_t SMEM_MAX = 227 * 1024;  // dynamic shared memory per block

template <typename T>
struct alignas(16) Vec4 {
    T x, y, z, w;
};

// r^2 is floored at 1e-30, a normal float: the flush-to-zero form gives
// rsqrtf's bits without its subnormal handling
__device__ __forceinline__ float inv_sqrt(float v) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
    return r;
}
__device__ __forceinline__ double inv_sqrt(double v) { return 1.0 / sqrt(v); }
__device__ __forceinline__ float t_exp(float v) { return expf(v); }
__device__ __forceinline__ double t_exp(double v) { return exp(v); }

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
// segment's panels.
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
// clamped to [0, K] (an index outside [0, nl_s) is an empty leaf).  No
// count the planner sees is then above K, and K <= cap (launch_one
// refuses the launch otherwise), so every segment takes at least one
// pair and the walk ends.
__device__ __forceinline__ void load_window(
        const int* __restrict__ src_idx, const int* __restrict__ src_cnt,
        int nl_s, int K, int w0, int p_end, int* psl, int* pcnt) {
    for (int i = threadIdx.x; i < WIN && w0 + i < p_end; i += BLOCK) {
        const int sl = src_idx[w0 + i];
        const bool ok = sl >= 0 && sl < nl_s;
        psl[i] = ok ? sl : 0;
        pcnt[i] = ok ? min(max(src_cnt[sl], 0), K) : 0;
    }
}

// Copy the real panels of pairs [pb, pb + np) into one stage, compacted:
// pts [n_seg][KQ] (x, y, z, w), nq [n_seg] (nx, ny, nz, q).  A warp takes
// a component row of a pair (4 KQ + 3 rows of the tile, then the charge
// row), its lanes the row's real slots: consecutive addresses.
template <typename T>
__device__ __forceinline__ void stage_segment(
        const T* __restrict__ src_tab, const T* __restrict__ ql,
        Vec4<T>* pts, Vec4<T>* nq, int np, int sl, int cnt, int off, int K,
        int KQ) {
    const int CS = 4 * KQ + 3;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int i = 0; i < np; ++i) {
        const int sl_i = __shfl_sync(0xffffffffu, sl, i);
        const int n_i = __shfl_sync(0xffffffffu, cnt, i);
        const int o_i = __shfl_sync(0xffffffffu, off, i);
        for (int c = warp; c <= CS; c += BLOCK / 32) {
            T* dst;
            int stride;  // in T, between consecutive panels
            const T* src;
            if (c < 4 * KQ) {  // quadrature point c % KQ, component c / KQ
                const int comp = c / KQ;
                dst = &pts[o_i * KQ + (c - comp * KQ)].x + comp;
                stride = 4 * KQ;
                src = src_tab + ((int64_t)sl_i * CS + c) * K;
            } else if (c < CS) {  // normal component
                dst = &nq[o_i].x + (c - 4 * KQ);
                stride = 4;
                src = src_tab + ((int64_t)sl_i * CS + c) * K;
            } else {  // charge
                dst = &nq[o_i].w;
                stride = 4;
                src = ql + (int64_t)sl_i * K;
            }
            for (int s = lane; s < n_i; s += 32)
                cp_async(dst + s * stride, src + s);
        }
    }
}

// One quadrature point v of panel n against the target (px, py, pz): the
// G term, or with DG the dG term.  The weight leads every product.
template <typename T, bool DG, bool YUKAWA>
__device__ __forceinline__ T term(const Vec4<T>& v, const Vec4<T>& n, T px,
                                  T py, T pz, T kappa) {
    const T dx = v.x - px, dy = v.y - py, dz = v.z - pz;
    T r2 = dx * dx + dy * dy + dz * dz;
    r2 = r2 > T(1e-30) ? r2 : T(1e-30);
    const T inv_r = inv_sqrt(r2);
    if (!DG) {
        if (YUKAWA) return (v.w * inv_r) * t_exp(-kappa * (r2 * inv_r));
        return v.w * inv_r;
    }
    const T inv_r2 = inv_r * inv_r;
    const T dn = dx * n.x + dy * n.y + dz * n.z;
    if (YUKAWA) {
        const T r = r2 * inv_r;
        const T wi = (v.w * inv_r) * t_exp(-kappa * r);
        return ((wi * dn) * (kappa * r + T(1))) * inv_r2;
    }
    return ((v.w * inv_r) * dn) * inv_r2;
}

// A thread's panels j0, j0 + G, ... of a staged segment against its two
// targets a and b, each by its own branch (chosen once, outside the loop).
template <typename T, int KQC, bool YUKAWA, bool DG_A, bool DG_B>
__device__ __forceinline__ void walk_segment(
        const Vec4<T>* pts, const Vec4<T>* nq, int KQ_rt, int j0, int n_seg,
        int G, const T (&a)[3], const T (&b)[3], T kappa, T& acc_a,
        T& acc_b) {
    const int KQ = KQC > 0 ? KQC : KQ_rt;
#pragma unroll 2
    for (int j = j0; j < n_seg; j += G) {
        const Vec4<T> n = nq[j];
        T sa = T(0), sb = T(0);
#pragma unroll
        for (int k = 0; k < KQ; ++k) {
            const Vec4<T> v = pts[j * KQ + k];
            sa += term<T, DG_A, YUKAWA>(v, n, a[0], a[1], a[2], kappa);
            sb += term<T, DG_B, YUKAWA>(v, n, b[0], b[1], b[2], kappa);
        }
        acc_a += sa * n.w;
        acc_b += sb * n.w;
    }
}

// KQC > 0: the quadrature order is a compile-time constant (unrolled);
// KQC == 0: it is the run-time argument KQ.
template <typename T, int KQC, bool YUKAWA>
__global__ void __launch_bounds__(BLOCK)
otf_tile_kernel(const T* __restrict__ src_tab, const T* __restrict__ ql,
                const T* __restrict__ tgt_tab, const int* __restrict__ row_ptr,
                const int* __restrict__ src_idx,
                const int* __restrict__ src_cnt,
                const int* __restrict__ tgt_cnt, T* __restrict__ out, int K,
                int nl_s, int KQ_rt, int cap, T kappa) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int KQ = KQC > 0 ? KQC : KQ_rt;
    const int per_stage = cap * (KQ + 1);  // Vec4 elements
    Vec4<T>* stage0 = reinterpret_cast<Vec4<T>*>(smem_raw);
    int* psl = reinterpret_cast<int*>(stage0 + 2 * per_stage);  // [WIN]
    int* pcnt = psl + WIN;                                       // [WIN]

    const int leaf = blockIdx.x;
    const int tile0 = blockIdx.y * BLOCK;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int n_here = min(max(min(tgt_cnt[leaf], K) - tile0, 0), BLOCK);
    const int p_begin = row_ptr[leaf];
    const int p_end = row_ptr[leaf + 1];
    T* orow = out + (int64_t)leaf * K + tile0;
    const bool out_live = tile0 + tid < K;

    if (n_here == 0 || p_begin == p_end) {  // exact zeros, no work
        if (out_live) orow[tid] = T(0);
        return;
    }

    // thread (tx, g) of group g holds targets tx and tx + TX of this tile
    const int TX = (n_here + 1) / 2;
    const int G = BLOCK / TX;
    const int g = tid / TX;
    const int tx = tid - g * TX;
    const bool live = g < G;
    const bool has_b = live && tx + TX < n_here;
    T ta[3] = {T(0), T(0), T(0)}, tb[3] = {T(0), T(0), T(0)};
    bool dg_a = false, dg_b = false;
    if (live) {
        const T* trow = tgt_tab + (int64_t)leaf * 4 * K + tile0;
        const int t_b = has_b ? tx + TX : tx;  // a lone target twice
        for (int d = 0; d < 3; ++d) {
            ta[d] = trow[d * K + tx];
            tb[d] = trow[d * K + t_b];
        }
        dg_a = trow[3 * K + tx] != T(0);
        dg_b = trow[3 * K + t_b] != T(0);
    }
    T acc_a = T(0), acc_b = T(0);

    int w0 = p_begin;
    load_window(src_idx, src_cnt, nl_s, K, w0, p_end, psl, pcnt);
    __syncthreads();
    int sl, cnt, off, n_cur, n_next = 0, np_next = 0;
    int pb = p_begin;
    int np = plan_segment(psl, pcnt, w0, pb, p_end, cap, lane, &sl, &cnt,
                          &off, &n_cur);
    stage_segment(src_tab, ql, stage0, stage0 + cap * KQ, np, sl, cnt, off,
                  K, KQ);
    cp_async_commit();
    pb += np;
    int buf = 0;
    while (true) {
        const bool more = pb < p_end;  // the same in every thread
        if (more) {
            if (pb - w0 + 32 > WIN && w0 + WIN < p_end) {
                __syncthreads();  // every warp has planned from the old one
                w0 = pb;          // slide the window
                load_window(src_idx, src_cnt, nl_s, K, w0, p_end, psl,
                            pcnt);
                __syncthreads();
            }
            Vec4<T>* nxt = stage0 + (buf ^ 1) * per_stage;
            np_next = plan_segment(psl, pcnt, w0, pb, p_end, cap, lane, &sl,
                                   &cnt, &off, &n_next);
            stage_segment(src_tab, ql, nxt, nxt + cap * KQ, np_next, sl, cnt,
                          off, K, KQ);
        }
        cp_async_commit();
        cp_async_wait<1>();  // this thread's copies of the current stage
        __syncthreads();     // ... and everyone else's

        const Vec4<T>* pts = stage0 + buf * per_stage;
        const Vec4<T>* nq = pts + cap * KQ;
        if (live) {
#define OTF_WALK(DA, DB)                                                    \
    walk_segment<T, KQC, YUKAWA, DA, DB>(pts, nq, KQ, g, n_cur, G, ta, tb,  \
                                         kappa, acc_a, acc_b)
            if (!dg_a) {
                if (!dg_b) OTF_WALK(false, false); else OTF_WALK(false, true);
            } else {
                if (!dg_b) OTF_WALK(true, false); else OTF_WALK(true, true);
            }
#undef OTF_WALK
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
    T* red = reinterpret_cast<T*>(smem_raw);  // [2][G][TX]
    if (live) {
        red[g * TX + tx] = acc_a;
        red[BLOCK + g * TX + tx] = acc_b;
    }
    __syncthreads();
    if (out_live) {
        T v = T(0);
        if (tid < n_here) {  // padded target slots are exactly zero
            const int t = tid < TX ? tid : tid - TX;
            const T* part = red + (tid < TX ? 0 : BLOCK);
            for (int gg = 0; gg < G; ++gg) v += part[gg * TX + t];
        }
        orow[tid] = v;
    }
}

template <typename T, int KQC, bool YUKAWA>
int launch_one(const void* src_tab, const void* ql, const void* tgt_tab,
               const void* row_ptr, const void* src_idx, const void* src_cnt,
               const void* tgt_cnt, void* out, int nl_t, int nl_s, int K,
               int KQ, double kappa, void* stream) {
    // two stages of cap panels, (KQ + 1) Vec4 each, beside the pair
    // window: as many panels as fit, at most CAP_MAX and at least K (a
    // segment takes whole pairs)
    const size_t per_panel = 2 * (size_t)(KQ + 1) * sizeof(Vec4<T>);
    const size_t fit = (SMEM_MAX - 2 * WIN * sizeof(int)) / per_panel;
    const int cap = fit < (size_t)CAP_MAX ? (int)fit : CAP_MAX;
    if (cap < K) return (int)cudaErrorInvalidValue;
    const size_t smem = cap * per_panel + 2 * WIN * sizeof(int);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            otf_tile_kernel<T, KQC, YUKAWA>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(nl_t, (K + BLOCK - 1) / BLOCK);
    otf_tile_kernel<T, KQC, YUKAWA>
        <<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
            (const T*)src_tab, (const T*)ql, (const T*)tgt_tab,
            (const int*)row_ptr, (const int*)src_idx, (const int*)src_cnt,
            (const int*)tgt_cnt, (T*)out, K, nl_s, KQ, cap, (T)kappa);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* src_tab, const void* ql, const void* tgt_tab,
           const void* row_ptr, const void* src_idx, const void* src_cnt,
           const void* tgt_cnt, void* out, int nl_t, int nl_s, int K,
           int KQ, double kappa, void* stream) {
    if (nl_t <= 0 || K <= 0) return (int)cudaSuccess;
    if (KQ <= 0) return (int)cudaErrorInvalidValue;
    const bool yukawa = kappa != 0.0;
#define OTF_ARGS src_tab, ql, tgt_tab, row_ptr, src_idx, src_cnt, tgt_cnt, \
                 out, nl_t, nl_s, K, KQ, kappa, stream
    if (KQ == 3) {
        return yukawa ? launch_one<T, 3, true>(OTF_ARGS)
                      : launch_one<T, 3, false>(OTF_ARGS);
    }
    return yukawa ? launch_one<T, 0, true>(OTF_ARGS)
                  : launch_one<T, 0, false>(OTF_ARGS);
#undef OTF_ARGS
}

}  // namespace

// Plain C interface.  All pointers are device pointers; the launch goes on
// the given stream, allocates nothing and does not synchronise.  Returns
// cudaGetLastError() (0 on success).
extern "C" int otf_tile_f32(const void* src_tab, const void* ql,
                            const void* tgt_tab, const void* row_ptr,
                            const void* src_idx, const void* src_cnt,
                            const void* tgt_cnt, void* out, int nl_t,
                            int nl_s, int K, int KQ, double kappa,
                            void* stream) {
    return launch<float>(src_tab, ql, tgt_tab, row_ptr, src_idx, src_cnt,
                         tgt_cnt, out, nl_t, nl_s, K, KQ, kappa, stream);
}

extern "C" int otf_tile_f64(const void* src_tab, const void* ql,
                            const void* tgt_tab, const void* row_ptr,
                            const void* src_idx, const void* src_cnt,
                            const void* tgt_cnt, void* out, int nl_t,
                            int nl_s, int K, int KQ, double kappa,
                            void* stream) {
    return launch<double>(src_tab, ql, tgt_tab, row_ptr, src_idx, src_cnt,
                          tgt_cnt, out, nl_t, nl_s, K, KQ, kappa, stream);
}
