// Yukawa BEM M2P over target leaf tiles for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs M2P as XLA-fused array
// code, and the port ran it as eager PyTorch, the p = 8 screened Taylor
// recurrence of kernels/cartesian.py::eval_coeffs as some 25 separate
// operations for each of its 165 terms, per chunk of pairs (about 7,200
// launches a matvec).  Added because those launches, not the arithmetic,
// held the Yukawa BEM solve: one launch now does every pair.
//
// For every target leaf b with pairs and every real slot t of it, over
// the leaf's pairs j (source box s_j, 1/sigma g_j, centre c_j)
//
//     out[leaves[b], t] += sign_t sum_j g_j sum_{|a|<=p}
//                          a! a_a(d; kappa / g_j) M[s_j, c_t, a]
//     d = (x_t - c_j) g_j,   c_t = 0, sign_t = + if bc[b, t] == 0, else 1, -
//
// which is YukawaBEMKernel.m2p: a! a_a(d / g; kappa) g^-|a| written scale
// free, a_a(sigma d; kappa) sigma^|a| = a_a(d; kappa sigma) / sigma, so
// f32 stays in range at every level.  a_a are the Taylor coefficients of
// e^{-kappa R} / R by the screened recurrence (b_a those of e^{-kappa R}):
//
//     n b_a = -k [s1(a) + s2(a)]
//     n R^2 a_a = -k [s1(b) + s2(b)] - (2n - 1) s1(a) - (n - 1) s2(a)
//     s1(f) = sum_d d_d f_{a - e_d},   s2(f) = sum_d f_{a - 2 e_d}
//
// with n = |a|, k = kappa / g, a_0 = e^{-k R} / R, b_0 = e^{-k R}.  Only
// the component bc selects is contracted.  M rows are [nbox, 2T],
// T = (p+1)(p+2)(p+3)/6: component-major, degree-ordered (within degree
// n the multi-indices (i, j, k) by descending i, then descending j).
// tab [T + 3(p+1)] holds a! per term, then per degree n (2n-1)/n,
// (n-1)/n and 1/n.
//
// What bounds it on this card: latency.  At the bench plan's 1,320 pairs
// (26,400 evaluations, about 3,500 flops each at p = 8) the operations
// take about 1.4 us at 67 TFLOP/s and the bytes (each M row once) well
// under a microsecond; the launch and the p dependent rounds of the
// recurrence set the time.
//
// Design.  Pairs are sorted by target leaf with a row pointer; block
// (b, y) takes slots [y*TK, (y+1)*TK) of leaf b, TK = 2, with Q = 16 pair
// lanes: NG = 32 groups of L = 16 lanes (half a warp), group (t, q)
// running pairs q, q + Q, ... against slot t.  Per round the block stages
// the next Q pairs' M rows (times a!; a warp a row), centres and 1/sigma
// in shared memory.  (Of the launch shapes timed on the bench plan, this
// one took the least time in f32 and f64 alike: small blocks of few
// slots spread a leaf over more SMs, and many pairs a round make few
// rounds.)  A group runs one evaluation a degree shell at a time: the
// shell's (n+1)(n+2)/2 terms are independent, spread over the group's
// lanes, and read only shells n-1 and n-2, so a ring of three shells
// (a and b) per group lives in shared memory and the 2T weights are
// never stored; each term is contracted with the staged row as soon as
// it exists.  A term's parents sit at fixed offsets in their shells
// (position u(u+1)/2 + k, u = j + k, in every shell), so no index table
// is read.  Each lane keeps its partial sum over terms and pairs; the
// lanes' sums are added by a fixed butterfly and the Q groups' sums of a
// slot in a fixed order through shared memory, then added once to out:
// no atomics, the same bits on every run.  Padded slots (past cnt) and
// leaves without pairs are not written.  A source box outside [0, nbox)
// is an empty pair, a count is clamped to [0, K], a leaf outside [0, nl)
// is skipped.  Shared memory grows with p (smem_bytes); the wrapper
// refuses an order that does not fit before it launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 16;              // lanes per evaluation (half a warp)
constexpr int TK = 2;              // target slots per block
constexpr int Q = 16;              // pair lanes: pairs staged per round
constexpr int NG = TK * Q;         // evaluation groups per block
constexpr int BLOCK = NG * L;      // threads per block
constexpr size_t SMEM_MAX = 227 * 1024;

__host__ __device__ inline int num_terms(int p) {
    return (p + 1) * (p + 2) * (p + 3) / 6;
}

__host__ __device__ inline int shell_size(int n) {
    return (n + 1) * (n + 2) / 2;
}

// tab, the staged rows, the pairs' geometry, the rings and the slot sums
// in T, then the pairs' flags and the shell positions' (u, k) in int
// (ops/m2p_cart_tile.py::smem_bytes is the same sum)
size_t smem_bytes(int p, size_t itemsize) {
    const size_t Tn = num_terms(p), S = shell_size(p);
    return (Tn + 3 * (p + 1) + Q * 2 * Tn + 4 * Q + NG * 6 * S + Q * TK)
               * itemsize
           + (Q + S) * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
m2p_cart_tile_kernel(const T* __restrict__ M, const T* __restrict__ centers,
                     const T* __restrict__ tab,
                     const int* __restrict__ leaves,
                     const int* __restrict__ row_ptr,
                     const int* __restrict__ src, const T* __restrict__ isig,
                     const int* __restrict__ cnt, const T* __restrict__ xyz,
                     const T* __restrict__ bc, T* __restrict__ out, int K,
                     int nl, int nbox, int npairs, int p, T kappa) {
    const int b = blockIdx.x;
    const int slot0 = blockIdx.y * TK;
    const int n_real = min(max(cnt[b], 0), K);
    const int leaf = leaves[b];
    if (slot0 >= n_real || leaf < 0 || leaf >= nl) return;  // whole block
    const int p_begin = max(row_ptr[b], 0);
    const int p_end = min(row_ptr[b + 1], npairs);
    if (p_begin >= p_end) return;

    const int Tn = num_terms(p);
    const int S = shell_size(p);
    const int row = 2 * Tn;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* fac = reinterpret_cast<T*>(smem_raw);  // [Tn] a!
    T* dfac = fac + Tn;                       // [p+1][3] per degree
    T* stage = dfac + 3 * (p + 1);            // [Q][2 Tn] a! M
    T* pgeo = stage + Q * row;                // [Q][4]: cx, cy, cz, g
    T* ring = pgeo + 4 * Q;                   // [NG][2][3][S]
    T* red = ring + NG * 6 * S;               // [Q][TK]
    int* pok = reinterpret_cast<int*>(red + Q * TK);  // [Q]
    int* uk = pok + Q;                        // [S]: u << 16 | k

    const int tid = threadIdx.x;
    for (int i = tid; i < Tn + 3 * (p + 1); i += BLOCK) fac[i] = tab[i];
    for (int i = tid; i < S; i += BLOCK) {
        int u = 0;
        while ((u + 1) * (u + 2) / 2 <= i) ++u;
        uk[i] = (u << 16) | (i - u * (u + 1) / 2);
    }
    const int lane = tid % L;
    const int gi = tid / L;
    const int tx = gi % TK;
    const int q = gi / TK;
    static_assert(L == 16, "a group is half a warp");
    const unsigned half = 0xFFFFu << (tid & 16);  // this group's lanes
    T* Ar = ring + (size_t)gi * 6 * S;  // [3][S] shells of a
    T* Br = Ar + 3 * S;                 // [3][S] shells of b

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
    T part = T(0);

    for (int r0 = p_begin; r0 < p_end; r0 += Q) {
        const int np = min(Q, p_end - r0);
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
        for (int j = tid / 32; j < np; j += BLOCK / 32) {  // a warp a row
            const int s = src[r0 + j];
            if (s < 0 || s >= nbox) continue;
            const T* Mr = M + (int64_t)s * row;
            T* st = stage + j * row;
#pragma unroll 4
            for (int k = tid % 32; k < row; k += 32)
                st[k] = fac[k < Tn ? k : k - Tn] * Mr[k];
        }
        __syncthreads();

        if (real && q < np && pok[q]) {  // uniform over the group
            const T* pg = pgeo + 4 * q;
            const T g = pg[3];
            const T x = (px - pg[0]) * g;
            const T y = (py - pg[1]) * g;
            const T z = (pz - pg[2]) * g;
            const T R2 = x * x + y * y + z * z;
            const T inv = T(1) / R2;
            const T R = sqrt(R2);
            const T kp = kappa / g;
            const T* Ms = stage + q * row + comp * Tn;
            T acc = T(0);
            if (lane == 0) {
                const T b0 = exp(-kp * R);
                const T a0 = b0 / R;
                Ar[0] = a0;
                Br[0] = b0;
                acc = a0 * Ms[0];
            }
            __syncwarp(half);
            int off = 1;  // flat index of shell n's first term
            for (int n = 1; n <= p; ++n) {
                const T* A1 = Ar + ((n - 1) % 3) * S;
                const T* B1 = Br + ((n - 1) % 3) * S;
                const T* A2 = Ar + ((n + 1) % 3) * S;  // shell n - 2
                const T* B2 = Br + ((n + 1) % 3) * S;
                T* A0 = Ar + (n % 3) * S;
                T* B0 = Br + (n % 3) * S;
                const T c1 = dfac[3 * n];
                const T c2 = dfac[3 * n + 1];
                const T kc = kp * dfac[3 * n + 2];
                const int Sn = shell_size(n);
                for (int pos = lane; pos < Sn; pos += L) {
                    const int e = uk[pos];
                    const int u = e >> 16;   // j + k; i = n - u
                    const int k = e & 0xFFFF;
                    const int j = u - k;
                    T sa1 = T(0), sb1 = T(0), sa2 = T(0), sb2 = T(0);
                    if (u < n) {             // a - e_x
                        sa1 = x * A1[pos];
                        sb1 = x * B1[pos];
                    }
                    if (j >= 1) {            // a - e_y
                        sa1 += y * A1[pos - u];
                        sb1 += y * B1[pos - u];
                    }
                    if (k >= 1) {            // a - e_z
                        sa1 += z * A1[pos - u - 1];
                        sb1 += z * B1[pos - u - 1];
                    }
                    if (u < n - 1) {         // a - 2 e_x
                        sa2 = A2[pos];
                        sb2 = B2[pos];
                    }
                    if (j >= 2) {            // a - 2 e_y
                        sa2 += A2[pos - 2 * u + 1];
                        sb2 += B2[pos - 2 * u + 1];
                    }
                    if (k >= 2) {            // a - 2 e_z
                        sa2 += A2[pos - 2 * u - 1];
                        sb2 += B2[pos - 2 * u - 1];
                    }
                    const T an = inv * (-kc * (sb1 + sb2) - c1 * sa1
                                        - c2 * sa2);
                    A0[pos] = an;
                    B0[pos] = -kc * (sa1 + sa2);
                    acc += an * Ms[off + pos];
                }
                off += Sn;
                __syncwarp(half);  // shell n is written and n-2 read out
            }
            part += g * acc;
        }
    }

    // the group's lanes, then the Q groups of a slot, in a fixed order
    for (int o = L / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xFFFFFFFFu, part, o);
    if (lane == 0) red[q * TK + tx] = part;
    __syncthreads();
    if (q == 0 && lane == 0 && real) {
        T s = T(0);
        for (int qq = 0; qq < Q; ++qq) s += red[qq * TK + tx];
        T* o = out + (int64_t)leaf * K + t;
        *o += comp == 0 ? s : -s;
    }
}

template <typename T>
int launch(const void* M, const void* centers, const void* tab,
           const void* leaves, const void* row_ptr, const void* src,
           const void* isig, const void* cnt, const void* xyz, const void* bc,
           void* out, int nb, int K, int nl, int nbox, int npairs, int p,
           double kappa, void* stream) {
    if (nb <= 0 || K <= 0 || npairs <= 0 || p <= 0) return (int)cudaSuccess;
    const size_t smem = smem_bytes(p, sizeof(T));
    if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            m2p_cart_tile_kernel<T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(nb, (K + TK - 1) / TK);
    m2p_cart_tile_kernel<T><<<grid, BLOCK, smem, (cudaStream_t)stream>>>(
        (const T*)M, (const T*)centers, (const T*)tab, (const int*)leaves,
        (const int*)row_ptr, (const int*)src, (const T*)isig,
        (const int*)cnt, (const T*)xyz, (const T*)bc, (T*)out, K, nl, nbox,
        npairs, p, (T)kappa);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface.  All pointers are device pointers; the launch goes on
// the given stream, allocates nothing and does not synchronise.  Returns
// cudaGetLastError() (0 on success).
extern "C" int m2p_cart_tile_f32(const void* M, const void* centers,
                                 const void* tab, const void* leaves,
                                 const void* row_ptr, const void* src,
                                 const void* isig, const void* cnt,
                                 const void* xyz, const void* bc, void* out,
                                 int nb, int K, int nl, int nbox, int npairs,
                                 int p, double kappa, void* stream) {
    return launch<float>(M, centers, tab, leaves, row_ptr, src, isig, cnt,
                         xyz, bc, out, nb, K, nl, nbox, npairs, p, kappa,
                         stream);
}

extern "C" int m2p_cart_tile_f64(const void* M, const void* centers,
                                 const void* tab, const void* leaves,
                                 const void* row_ptr, const void* src,
                                 const void* isig, const void* cnt,
                                 const void* xyz, const void* bc, void* out,
                                 int nb, int K, int nl, int nbox, int npairs,
                                 int p, double kappa, void* stream) {
    return launch<double>(M, centers, tab, leaves, row_ptr, src, isig, cnt,
                          xyz, bc, out, nb, K, nl, nbox, npairs, p, kappa,
                          stream);
}

// The dynamic shared memory a launch at order p takes, in bytes (the
// wrapper's own sum is checked against it on the card).
extern "C" long long m2p_cart_tile_smem_bytes(int p, int itemsize) {
    return (long long)smem_bytes(p, (size_t)itemsize);
}
