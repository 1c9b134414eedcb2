// Yukawa BEM L2P over target leaf tiles for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs L2P as XLA-fused array
// code, and the port ran it as eager PyTorch, the monomials v^a / a! of
// kernels/cartesian.py::powers built one multiply and one divide at a
// time (about 330 launches at p = 8), stacked on their last axis (a
// strided copy of 165 planes over every slot), contracted with a copy of
// each leaf's expansion made per slot, then two selects.  Added because
// that chain, not the arithmetic, took about 2.5 ms of card time an L2P
// in the Yukawa BEM solve: one launch now does every slot.
//
// For every target leaf b (box leaves[b]) and every slot t of its tile
//
//     out[b K + t] = mask ? sign_t sum_{|a|<=p} L[leaves[b], c_t, a]
//                                                d^a / a!  : 0
//     d = d_norm[b K + t],   c_t = 0, sign_t = + if bc[b K + t] == 0,
//                            else 1, -
//
// which is YukawaBEMKernel.l2p in slot layout, as FmmPlan._l2p_slots ran
// it: the component bc selects, padded slots exactly 0.  L rows are
// [nbox, 2T], T = (p+1)(p+2)(p+3)/6: component-major, degree-ordered
// (within degree n the multi-indices (i, j, k) by descending i, then
// descending j, so (i, j, k) sits at n(n+1)(n+2)/6 + u(u+1)/2 + k with
// n = i + j + k, u = j + k).  tab [p + 2] holds 1/m at m >= 1 (0 at 0).
//
// What bounds it on this card: latency.  The bench plan's 267,776 slots
// (4,184 leaves of 64) read 12 B of offset, 4 B of flag and 1 B of mask
// and write 4 B each, and the leaves' rows 1.3 KB each at p = 8: about
// 11 MB, 3.3 us at 3.35 TB/s; the terms, 165 a slot at about 4 flops,
// 0.18 GFLOP, 2.6 us at 67 TFLOP/s.
//
// Design.  One block a target leaf: its 2T coefficients are staged once
// in shared memory (no per-slot copy of the expansion), one thread a
// slot.  A thread walks i, j, k with x^i / i!, y^j / j! and z^k / k!
// carried as running products in registers, so no monomial is stored,
// and contracts only the component its flag selects: half the work of
// two contractions.  Every thread reads the same coefficient at a step
// (a broadcast, two addresses in a tile of mixed flags).  Each thread
// sums its own terms in one fixed order: no atomics, the same bits on
// every run.  A box id outside [0, nbox) reads as an empty expansion (its
// slots are 0).  Shared memory grows with p (smem_bytes): the wrapper
// takes orders to 20, 28 KB in f64, inside a block's default 48 KB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_BLOCK = 256;     // threads per block, at most

__host__ __device__ inline int num_terms(int p) {
    return (p + 1) * (p + 2) * (p + 3) / 6;
}

// the leaf's two components, then the reciprocals
size_t smem_bytes(int p, size_t itemsize) {
    return (2 * (size_t)num_terms(p) + p + 2) * itemsize;
}

// a warp for a tile of up to 32 slots, up to MAX_BLOCK threads for a
// larger one; a thread takes slots t, t + blockDim.x, ...
int block_threads(int K) {
    const int w = (K + 31) / 32 * 32;
    return w < MAX_BLOCK ? w : MAX_BLOCK;
}

template <typename T>
__global__ void __launch_bounds__(MAX_BLOCK)
l2p_cart_tile_kernel(const T* __restrict__ L,
                     const int64_t* __restrict__ leaves,
                     const T* __restrict__ dn, const T* __restrict__ bc,
                     const unsigned char* __restrict__ mask,
                     const T* __restrict__ tab, T* __restrict__ out, int K,
                     int nbox, int p) {
    const int b = blockIdx.x;
    const int Tn = num_terms(p);
    const int row = 2 * Tn;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* coef = reinterpret_cast<T*>(smem_raw);  // [2 Tn] the leaf's row
    T* rinv = coef + row;                      // [p + 2] 1/m

    const int64_t leaf = leaves[b];
    const bool ok = leaf >= 0 && leaf < nbox;
    if (ok) {
        const T* Lr = L + leaf * row;
        for (int i = threadIdx.x; i < row; i += blockDim.x) coef[i] = Lr[i];
    }
    for (int i = threadIdx.x; i < p + 2; i += blockDim.x) rinv[i] = tab[i];
    __syncthreads();

    for (int t = threadIdx.x; t < K; t += blockDim.x) {
        const int64_t s = (int64_t)b * K + t;
        T r = T(0);
        if (ok && mask[s]) {
            const T x = dn[3 * s + 0];
            const T y = dn[3 * s + 1];
            const T z = dn[3 * s + 2];
            const bool second = bc[s] != T(0);
            const T* c = coef + (second ? Tn : 0);
            T acc = T(0);
            T xi = T(1);  // x^i / i!
            for (int i = 0; i <= p; ++i) {
                T yj = T(1);  // y^j / j!
                for (int j = 0; j <= p - i; ++j) {
                    const T xy = xi * yj;
                    T zk = T(1);  // z^k / k!
                    for (int k = 0; k <= p - i - j; ++k) {
                        const int n = i + j + k;
                        const int u = j + k;
                        acc += c[n * (n + 1) * (n + 2) / 6 + u * (u + 1) / 2
                                 + k] * (xy * zk);
                        zk *= z * rinv[k + 1];
                    }
                    yj *= y * rinv[j + 1];
                }
                xi *= x * rinv[i + 1];
            }
            r = second ? -acc : acc;
        }
        out[s] = r;
    }
}

template <typename T>
int launch(const void* L, const void* leaves, const void* dn, const void* bc,
           const void* mask, const void* tab, void* out, int nl, int K,
           int nbox, int p, void* stream) {
    if (nl <= 0 || K <= 0 || p < 0) return (int)cudaSuccess;
    l2p_cart_tile_kernel<T><<<nl, block_threads(K), smem_bytes(p, sizeof(T)),
                              (cudaStream_t)stream>>>(
        (const T*)L, (const int64_t*)leaves, (const T*)dn, (const T*)bc,
        (const unsigned char*)mask, (const T*)tab, (T*)out, K, nbox, p);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface.  All pointers are device pointers; the launch goes on
// the given stream, allocates nothing and does not synchronise.  Returns
// cudaGetLastError() (0 on success).
extern "C" int l2p_cart_tile_f32(const void* L, const void* leaves,
                                 const void* dn, const void* bc,
                                 const void* mask, const void* tab,
                                 void* out, int nl, int K, int nbox, int p,
                                 void* stream) {
    return launch<float>(L, leaves, dn, bc, mask, tab, out, nl, K, nbox, p,
                         stream);
}

extern "C" int l2p_cart_tile_f64(const void* L, const void* leaves,
                                 const void* dn, const void* bc,
                                 const void* mask, const void* tab,
                                 void* out, int nl, int K, int nbox, int p,
                                 void* stream) {
    return launch<double>(L, leaves, dn, bc, mask, tab, out, nl, K, nbox, p,
                          stream);
}

