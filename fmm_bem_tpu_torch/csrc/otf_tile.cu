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
// weights (times area; 0 for padded panels) and the panel normal; target
// tiles [nl + 1, 4, K] hold x, y, z and the BC flag; charges are
// [nl_s, K].  Padded panels sit at a far sentinel position: as sources
// their weight is 0, as targets their output is written as exactly 0.
//
// What bounds it on this card: operations.  A source tile is a few KB and
// serves K*K*KQ kernel evaluations of 10 (G) to 18 (dG) needed flops and
// one reciprocal square root (plus one exponential when kappa > 0) each;
// the bytes are a percent of the arithmetic time and stay in L2.
//
// Design.  The TPU kernel stages each super-block's source-leaf union in
// fast memory, in segments, and accumulates into a resident output block
// over a sequential grid; here source tiles are read straight from the
// leaf table.  The pair list is sorted by target leaf, so a row pointer
// gives each leaf a contiguous range: one block owns one target leaf (and
// one tile of TX targets of it).  A block is TX x G threads: thread
// (t, g) keeps target t's coordinates, BC flag and partial sum in
// registers and walks the source tiles g, g + G, ... of the range; each
// group stages its tile in shared memory as (x, y, z, w) vectors per
// quadrature point and (nx, ny, nz, q) per panel, each read back as one
// broadcast 16-byte load.  The zero weight is always the first factor of
// a product, so a padded target against a padded source (r^2 at its
// floor, 1/r^3 beyond the f32 range) yields 0, never NaN.  The G partial
// sums are added in a fixed order through shared memory and stored once:
// no atomics, the same bits on every run, leaves without pairs get 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;  // threads per block (TX * G <= BLOCK)

template <typename T>
struct alignas(16) Vec4 {
    T x, y, z, w;
};

__device__ __forceinline__ float inv_sqrt(float v) { return rsqrtf(v); }
__device__ __forceinline__ double inv_sqrt(double v) { return 1.0 / sqrt(v); }
__device__ __forceinline__ float t_exp(float v) { return expf(v); }
__device__ __forceinline__ double t_exp(double v) { return exp(v); }

// KQC > 0: the quadrature order is a compile-time constant (unrolled);
// KQC == 0: it is the run-time argument KQ.
template <typename T, int KQC, bool YUKAWA>
__global__ void __launch_bounds__(BLOCK)
otf_tile_kernel(const T* __restrict__ src_tab, const T* __restrict__ ql,
                const T* __restrict__ tgt_tab, const int* __restrict__ row_ptr,
                const int* __restrict__ src_idx, T* __restrict__ out, int K,
                int KQ_rt, T kappa, T sentinel_half) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int KQ = KQC > 0 ? KQC : KQ_rt;
    const int CS = 4 * KQ + 3;
    const int per_group = K * KQ + K;  // Vec4 elements staged by one group
    Vec4<T>* stage = reinterpret_cast<Vec4<T>*>(smem_raw);  // [G][per_group]

    const int TX = blockDim.x;
    const int G = blockDim.y;
    const int tx = threadIdx.x;
    const int g = threadIdx.y;
    const int leaf = blockIdx.x;
    const int t = blockIdx.y * TX + tx;
    const bool live = t < K;

    const T* trow = tgt_tab + (int64_t)leaf * 4 * K;
    T px = T(0), py = T(0), pz = T(0);
    bool is_g = true;
    if (live) {
        px = trow[t];
        py = trow[K + t];
        pz = trow[2 * K + t];
        is_g = trow[3 * K + t] == T(0);
    }
    T acc = T(0);

    const int p_begin = row_ptr[leaf];
    const int p_end = row_ptr[leaf + 1];
    Vec4<T>* pts = stage + (int64_t)g * per_group;  // [K][KQ]
    Vec4<T>* nq = pts + K * KQ;                      // [K]

    for (int base = p_begin; base < p_end; base += G) {
        const int p = base + g;
        const bool have = p < p_end;  // the last round may be short
        const int sl = have ? src_idx[p] : 0;
        __syncthreads();  // every group is done with its previous tile
        if (have) {
            const T* srow = src_tab + (int64_t)sl * CS * K;
            for (int i = tx; i < K * KQ; i += TX) {
                const int k = i / K;
                const int s = i - k * K;
                Vec4<T> v;
                v.x = srow[(0 * KQ + k) * K + s];
                v.y = srow[(1 * KQ + k) * K + s];
                v.z = srow[(2 * KQ + k) * K + s];
                v.w = srow[(3 * KQ + k) * K + s];
                pts[s * KQ + k] = v;
            }
            const T* qrow = ql + (int64_t)sl * K;
            for (int s = tx; s < K; s += TX) {
                Vec4<T> v;
                v.x = srow[(4 * KQ + 0) * K + s];
                v.y = srow[(4 * KQ + 1) * K + s];
                v.z = srow[(4 * KQ + 2) * K + s];
                v.w = qrow[s];
                nq[s] = v;
            }
        }
        __syncthreads();
        if (have && live) {
#pragma unroll 2
            for (int s = 0; s < K; ++s) {
                const Vec4<T> n = nq[s];
                T Gs = T(0), dGs = T(0);
#pragma unroll
                for (int k = 0; k < KQ; ++k) {
                    const Vec4<T> v = pts[s * KQ + k];
                    const T dx = v.x - px, dy = v.y - py, dz = v.z - pz;
                    T r2 = dx * dx + dy * dy + dz * dz;
                    r2 = r2 > T(1e-30) ? r2 : T(1e-30);
                    const T inv_r = inv_sqrt(r2);
                    const T inv_r2 = inv_r * inv_r;
                    const T dn = dx * n.x + dy * n.y + dz * n.z;
                    // the weight (0 for padded panels) leads every product
                    T wi = v.w * inv_r;
                    if (YUKAWA) {
                        const T r = r2 * inv_r;
                        wi = wi * t_exp(-kappa * r);
                        Gs += wi;
                        dGs += ((wi * dn) * (kappa * r + T(1))) * inv_r2;
                    } else {
                        Gs += wi;
                        dGs += (wi * dn) * inv_r2;
                    }
                }
                acc += (is_g ? Gs : dGs) * n.w;
            }
        }
    }

    // add the G groups' partial sums in a fixed order
    __syncthreads();
    T* red = reinterpret_cast<T*>(smem_raw);  // [G][TX]
    red[g * TX + tx] = acc;
    __syncthreads();
    if (g == 0 && live) {
        T v = T(0);
        for (int gg = 0; gg < G; ++gg) v += red[gg * TX + tx];
        // padded target slots are exactly zero
        if (px >= sentinel_half) v = T(0);
        out[(int64_t)leaf * K + t] = v;
    }
}

template <typename T, int KQC, bool YUKAWA>
int launch_one(const void* src_tab, const void* ql, const void* tgt_tab,
               const void* row_ptr, const void* src_idx, void* out, int nl_t,
               int K, int KQ, double kappa, double sentinel, void* stream) {
    int TX = ((K + 31) / 32) * 32;
    if (TX > BLOCK) TX = BLOCK;
    const int G = BLOCK / TX;
    const size_t stage_bytes = (size_t)G * (K * KQ + K) * sizeof(Vec4<T>);
    const size_t red_bytes = (size_t)G * TX * sizeof(T);
    const size_t smem = stage_bytes > red_bytes ? stage_bytes : red_bytes;
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            otf_tile_kernel<T, KQC, YUKAWA>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(nl_t, (K + TX - 1) / TX);
    const dim3 block(TX, G);
    otf_tile_kernel<T, KQC, YUKAWA>
        <<<grid, block, smem, (cudaStream_t)stream>>>(
            (const T*)src_tab, (const T*)ql, (const T*)tgt_tab,
            (const int*)row_ptr, (const int*)src_idx, (T*)out, K, KQ,
            (T)kappa, (T)(0.5 * sentinel));
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* src_tab, const void* ql, const void* tgt_tab,
           const void* row_ptr, const void* src_idx, void* out, int nl_t,
           int K, int KQ, double kappa, double sentinel, void* stream) {
    if (nl_t <= 0 || K <= 0) return (int)cudaSuccess;
    if (KQ <= 0) return (int)cudaErrorInvalidValue;
    const bool yukawa = kappa != 0.0;
    if (KQ == 3) {
        return yukawa
            ? launch_one<T, 3, true>(src_tab, ql, tgt_tab, row_ptr, src_idx,
                                     out, nl_t, K, KQ, kappa, sentinel, stream)
            : launch_one<T, 3, false>(src_tab, ql, tgt_tab, row_ptr, src_idx,
                                      out, nl_t, K, KQ, kappa, sentinel,
                                      stream);
    }
    return yukawa
        ? launch_one<T, 0, true>(src_tab, ql, tgt_tab, row_ptr, src_idx, out,
                                 nl_t, K, KQ, kappa, sentinel, stream)
        : launch_one<T, 0, false>(src_tab, ql, tgt_tab, row_ptr, src_idx, out,
                                  nl_t, K, KQ, kappa, sentinel, stream);
}

}  // namespace

// Plain C interface.  All pointers are device pointers; the launch goes on
// the given stream, allocates nothing and does not synchronise.  Returns
// cudaGetLastError() (0 on success).
extern "C" int otf_tile_f32(const void* src_tab, const void* ql,
                            const void* tgt_tab, const void* row_ptr,
                            const void* src_idx, void* out, int nl_t, int K,
                            int KQ, double kappa, double sentinel,
                            void* stream) {
    return launch<float>(src_tab, ql, tgt_tab, row_ptr, src_idx, out, nl_t, K,
                         KQ, kappa, sentinel, stream);
}

extern "C" int otf_tile_f64(const void* src_tab, const void* ql,
                            const void* tgt_tab, const void* row_ptr,
                            const void* src_idx, void* out, int nl_t, int K,
                            int KQ, double kappa, double sentinel,
                            void* stream) {
    return launch<double>(src_tab, ql, tgt_tab, row_ptr, src_idx, out, nl_t,
                          K, KQ, kappa, sentinel, stream);
}
