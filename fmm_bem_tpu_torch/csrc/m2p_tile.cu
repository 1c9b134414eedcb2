// Laplace BEM M2P over target leaf tiles for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs M2P as XLA-fused array
// code, and the port ran it as eager PyTorch, the p = 10 recurrences of
// kernels/laplace.py::eval_singular as some 740 separate operations per
// chunk of pairs.  Added because those launches, not the arithmetic, held
// the BEM solve: one launch now does every pair.
//
// For every target leaf b with pairs and every real slot t of it, over
// the leaf's pairs j (source box s_j, 1/sigma g_j, centre c_j)
//
//     out[leaves[b], t] += sign_t sum_j g_j sum_{n<p, 0<=m<=n}
//         F_nm (Re M[s_j, c_t, nm] Re S_n^m(d) - Im M[s_j, c_t, nm] Im S_n^m(d))
//     d = (x_t - c_j) g_j,   c_t = 0, sign_t = + if bc[b, t] == 0, else 1, -
//
// with F_nm = w_m prefac(n, m) and S_n^m the singular solid harmonics by
// the Cartesian two-term recurrence of eval_singular (per order m a
// column n = m, m + 1, ... from the diagonal term; A_nm = (2n-1)/(n-m),
// B_nm = (n+m-1)/(n-m); the three factors come in coef [3, T]).  Only
// the component bc selects is contracted.  M rows are [nbox, 2W],
// W = p(p+1): component-major, each (re, im) interleaved, degree-ordered.
//
// What bounds it on this card: bytes and operations about alike, each
// source box's M row (2W values) read once against about 14 flops per
// term of every evaluation (target slot, pair); at the bench plan's 1,320
// pairs both come to a third of a microsecond, so the launch and the
// latency of a few dependent rounds set its time.
//
// Design.  Pairs are sorted by target leaf with a row pointer; block
// (b, y) takes slots [y*TK, (y+1)*TK) of leaf b, TK = 32, with G = 16
// lane groups over the leaf's pairs: thread (t, g) runs pairs g, g + G,
// ... against slot t.  Per round the block stages the next G pairs'
// M rows (16-byte loads where the rows are aligned), centres and 1/sigma
// in shared memory; a warp is 32 slots on one pair, so every M value it
// reads is a broadcast.  Each thread runs the recurrence streaming: only
// the current m column's last two terms live in registers, so any p fits
// without arrays.  The G partial sums are added in a fixed order through
// shared memory and added once to out: no atomics, the same bits on
// every run.  Padded slots (past cnt) and leaves without pairs are not
// written.  A source box outside [0, nbox) is an empty pair, a count is
// clamped to [0, K], a leaf outside [0, nl) is skipped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TK = 32;             // target slots per block
constexpr int G = 16;              // lane groups over the pairs
constexpr int BLOCK = TK * G;      // threads per block
constexpr size_t SMEM_MAX = 227 * 1024;

template <typename T> struct Vec16;
template <> struct alignas(16) Vec16<float> { float v[4]; };
template <> struct alignas(16) Vec16<double> { double v[2]; };

template <typename T>
__global__ void __launch_bounds__(BLOCK)
m2p_tile_kernel(const T* __restrict__ M, const T* __restrict__ centers,
                const T* __restrict__ coef, const int* __restrict__ leaves,
                const int* __restrict__ row_ptr, const int* __restrict__ src,
                const T* __restrict__ isig, const int* __restrict__ cnt,
                const T* __restrict__ xyz, const T* __restrict__ bc,
                T* __restrict__ out, int K, int nl, int nbox, int npairs,
                int p) {
    const int b = blockIdx.x;
    const int slot0 = blockIdx.y * TK;
    const int n_real = min(max(cnt[b], 0), K);
    const int leaf = leaves[b];
    if (slot0 >= n_real || leaf < 0 || leaf >= nl) return;  // whole block
    const int p_begin = max(row_ptr[b], 0);
    const int p_end = min(row_ptr[b + 1], npairs);
    if (p_begin >= p_end) return;

    const int W = p * (p + 1);   // real slots per component
    const int T_ = W / 2;        // complex terms
    const int row = 2 * W;       // values per M row
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* stage = reinterpret_cast<T*>(smem_raw);  // [G][row]
    T* pgeo = stage + G * row;                   // [G][4]: cx, cy, cz, g
    T* red = pgeo + 4 * G;                       // [G][TK]
    T* cf = red + G * TK;                        // [3][T_]
    int* pok = reinterpret_cast<int*>(cf + 3 * T_);  // [G]

    const int tid = threadIdx.x;
    const int tx = tid % TK;
    const int g = tid / TK;
    for (int i = tid; i < 3 * T_; i += BLOCK) cf[i] = coef[i];
    const T* F = cf;
    const T* A = cf + T_;
    const T* B = cf + 2 * T_;

    const int t = slot0 + tx;
    const bool real = t < n_real;
    T px = T(0), py = T(0), pz = T(0);
    int comp = 0;
    if (real) {
        const T* x = xyz + ((int64_t)b * K + t) * 3;
        px = x[0];
        py = x[1];
        pz = x[2];
        comp = bc[(int64_t)b * K + t] == T(0) ? 0 : 1;
    }
    const bool vec = (reinterpret_cast<uintptr_t>(M) & 15) == 0;
    constexpr int VW = 16 / sizeof(T);  // values per 16-byte load
    T part = T(0);

    for (int r0 = p_begin; r0 < p_end; r0 += G) {
        const int np = min(G, p_end - r0);
        __syncthreads();  // the last round's stage is read out
        if (tid < np) {
            const int s = src[r0 + tid];
            const bool ok = s >= 0 && s < nbox;
            pok[tid] = ok;
            if (ok) {
                pgeo[4 * tid + 0] = centers[3 * (int64_t)s + 0];
                pgeo[4 * tid + 1] = centers[3 * (int64_t)s + 1];
                pgeo[4 * tid + 2] = centers[3 * (int64_t)s + 2];
                pgeo[4 * tid + 3] = isig[r0 + tid];
            }
        }
        // the np rows, one warp-strided sweep over all of them
        if (vec) {
            const int nv = row / VW;  // row is a multiple of VW: W is even
            for (int i = tid; i < np * nv; i += BLOCK) {
                const int j = i / nv;
                const int k = i - j * nv;
                const int s = src[r0 + j];
                if (s < 0 || s >= nbox) continue;
                reinterpret_cast<Vec16<T>*>(stage + j * row)[k] =
                    reinterpret_cast<const Vec16<T>*>(
                        M + (int64_t)s * row)[k];
            }
        } else {
            for (int i = tid; i < np * row; i += BLOCK) {
                const int j = i / row;
                const int k = i - j * row;
                const int s = src[r0 + j];
                if (s < 0 || s >= nbox) continue;
                stage[j * row + k] = M[(int64_t)s * row + k];
            }
        }
        __syncthreads();

        if (real && g < np && pok[g]) {
            const T* pg = pgeo + 4 * g;
            const T gs = pg[3];
            const T x = (px - pg[0]) * gs;
            const T y = (py - pg[1]) * gs;
            const T z = (pz - pg[2]) * gs;
            const T inv = T(1) / (x * x + y * y + z * z);
            const T* Mc = stage + g * row + comp * W;
            T br = sqrt(inv), bi = T(0);
            T acc = T(0);
            for (int m = 0; m < p; ++m) {
                if (m > 0) {
                    const T c = T(-(2 * m - 1)) * inv;
                    const T nr = c * (br * x - bi * y);
                    const T ni = c * (br * y + bi * x);
                    br = nr;
                    bi = ni;
                }
                T r1 = br, i1 = bi, r2 = T(0), i2 = T(0);
                int idx = m * (m + 1) / 2 + m;
                for (int n = m; n < p; ++n) {
                    if (n > m) {
                        const T az = A[idx] * z;
                        const T nr = (az * r1 - B[idx] * r2) * inv;
                        const T ni = (az * i1 - B[idx] * i2) * inv;
                        r2 = r1;
                        i2 = i1;
                        r1 = nr;
                        i1 = ni;
                    }
                    acc += F[idx] * (Mc[2 * idx] * r1 - Mc[2 * idx + 1] * i1);
                    idx += n + 1;
                }
            }
            part += gs * acc;
        }
    }

    // add the G groups' partial sums in a fixed order
    red[g * TK + tx] = part;
    __syncthreads();
    if (g == 0 && real) {
        T s = T(0);
        for (int gg = 0; gg < G; ++gg) s += red[gg * TK + tx];
        T* o = out + (int64_t)leaf * K + t;
        *o += comp == 0 ? s : -s;
    }
}

template <typename T>
size_t smem_bytes(int p) {
    const int W = p * (p + 1);
    return ((size_t)G * 2 * W + 4 * G + (size_t)G * TK + 3 * (W / 2))
               * sizeof(T)
           + G * sizeof(int);
}

template <typename T>
int launch(const void* M, const void* centers, const void* coef,
           const void* leaves, const void* row_ptr, const void* src,
           const void* isig, const void* cnt, const void* xyz, const void* bc,
           void* out, int nb, int K, int nl, int nbox, int npairs, int p,
           void* stream) {
    if (nb <= 0 || K <= 0 || npairs <= 0 || p <= 0) return (int)cudaSuccess;
    const size_t smem = smem_bytes<T>(p);
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            m2p_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(nb, (K + TK - 1) / TK);
    m2p_tile_kernel<T><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
        (const T*)M, (const T*)centers, (const T*)coef, (const int*)leaves,
        (const int*)row_ptr, (const int*)src, (const T*)isig,
        (const int*)cnt, (const T*)xyz, (const T*)bc, (T*)out, K, nl, nbox,
        npairs, p);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface.  All pointers are device pointers; the launch goes on
// the given stream, allocates nothing and does not synchronise.  Returns
// cudaGetLastError() (0 on success).
extern "C" int m2p_tile_f32(const void* M, const void* centers,
                            const void* coef, const void* leaves,
                            const void* row_ptr, const void* src,
                            const void* isig, const void* cnt,
                            const void* xyz, const void* bc, void* out,
                            int nb, int K, int nl, int nbox, int npairs,
                            int p, void* stream) {
    return launch<float>(M, centers, coef, leaves, row_ptr, src, isig, cnt,
                         xyz, bc, out, nb, K, nl, nbox, npairs, p, stream);
}

extern "C" int m2p_tile_f64(const void* M, const void* centers,
                            const void* coef, const void* leaves,
                            const void* row_ptr, const void* src,
                            const void* isig, const void* cnt,
                            const void* xyz, const void* bc, void* out,
                            int nb, int K, int nl, int nbox, int npairs,
                            int p, void* stream) {
    return launch<double>(M, centers, coef, leaves, row_ptr, src, isig, cnt,
                          xyz, bc, out, nb, K, nl, nbox, npairs, p, stream);
}
