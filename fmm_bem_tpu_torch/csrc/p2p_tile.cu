// Point-Laplace P2P over near leaf pairs for Hopper (sm_90a).
//
// Replaces the TPU kernel fmm_bem_tpu/ops/p2p_tile.py::p2p_superblock_laplace.
// For every target leaf l and every source leaf s of its near list
//
//     pot[l, t]  += sum_j q[s, j] / r
//     f_d[l, t]  += sum_j q[s, j] (x_d[s, j] - x_d[l, t]) / r^3      d = 0..2
//
// with r = |x[s, j] - x[l, t]|; pairs with r^2 < eps2 contribute 0 (the
// self pair, and padded source slots that alias a target).  Leaves are
// packed tiles xyzq [nl + 1, 4, K] (rows x, y, z, q; padded slots carry
// q = 0); the result is [nl_t, 4, K] (rows pot, fx, fy, fz).
//
// What bounds it on this card: operations.  A source tile is 16*K bytes
// and serves K*K pair evaluations of about 20 flops and one reciprocal
// square root each, so the memory traffic is a few percent of the
// arithmetic time and the tiles stay in L2.
//
// Design.  The TPU kernel stages each super-block's source-leaf union in
// fast memory and accumulates into a resident output block over a
// sequential grid; here the source tiles are read straight from the leaf
// table and nothing carries over between blocks.  The pair list is sorted
// by target leaf, so a row pointer gives each leaf a contiguous range:
// one block owns one target leaf (and one tile of TX targets of it).  A
// block is TX x G threads: thread (t, g) keeps target t's coordinates and
// its four partial sums in registers and walks the source tiles
// g, g + G, ... of the range; each group stages its tile in shared memory
// as (x, y, z, q) vectors, read back as one broadcast 16-byte load per
// source.  The G partial sums are added in a fixed order through shared
// memory and stored once: no atomics, the same bits on every run, and
// leaves without pairs get 0.

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

template <typename T>
__global__ void __launch_bounds__(BLOCK)
p2p_tile_kernel(const T* __restrict__ xyzq, const int* __restrict__ row_ptr,
                const int* __restrict__ src_idx, T* __restrict__ out, int K,
                int nl_src, T eps2) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Vec4<T>* tiles = reinterpret_cast<Vec4<T>*>(smem_raw);  // [G][K]

    const int TX = blockDim.x;
    const int G = blockDim.y;
    const int tx = threadIdx.x;
    const int g = threadIdx.y;
    const int leaf = blockIdx.x;
    const int t = blockIdx.y * TX + tx;
    const bool live = t < K;

    const T* trow = xyzq + (int64_t)leaf * 4 * K;
    T px = T(0), py = T(0), pz = T(0);
    if (live) {
        px = trow[t];
        py = trow[K + t];
        pz = trow[2 * K + t];
    }
    T pot = T(0), fx = T(0), fy = T(0), fz = T(0);

    const int p_begin = row_ptr[leaf];
    const int p_end = row_ptr[leaf + 1];
    Vec4<T>* mine = tiles + (int64_t)g * K;

    for (int base = p_begin; base < p_end; base += G) {
        const int p = base + g;
        // an index outside the leaf table (the dummy leaf) is an empty tile
        const int sl = p < p_end ? src_idx[p] : -1;
        const bool have = sl >= 0 && sl < nl_src;
        __syncthreads();  // every group is done with its previous tile
        if (have) {
            const T* srow = xyzq + (int64_t)sl * 4 * K;
            for (int s = tx; s < K; s += TX) {
                Vec4<T> v;
                v.x = srow[s];
                v.y = srow[K + s];
                v.z = srow[2 * K + s];
                v.w = srow[3 * K + s];
                mine[s] = v;
            }
        }
        __syncthreads();
        if (have && live) {
#pragma unroll 4
            for (int s = 0; s < K; ++s) {
                const Vec4<T> v = mine[s];
                const T dx = v.x - px, dy = v.y - py, dz = v.z - pz;
                const T r2 = dx * dx + dy * dy + dz * dz;
                // excluded pairs give exactly 0, never 1 / eps2
                const T inv_r =
                    r2 < eps2 ? T(0) : inv_sqrt(r2 > eps2 ? r2 : eps2);
                const T qr = v.w * inv_r;
                const T w = qr * (inv_r * inv_r);
                pot += qr;
                // difference form: sum_s w (s_d - t_d), per component
                fx += w * dx;
                fy += w * dy;
                fz += w * dz;
            }
        }
    }

    // add the G groups' partial sums in a fixed order
    __syncthreads();
    T* red = reinterpret_cast<T*>(smem_raw);  // [G][4][TX]
    red[(g * 4 + 0) * TX + tx] = pot;
    red[(g * 4 + 1) * TX + tx] = fx;
    red[(g * 4 + 2) * TX + tx] = fy;
    red[(g * 4 + 3) * TX + tx] = fz;
    __syncthreads();
    if (g == 0 && live) {
        T* orow = out + (int64_t)leaf * 4 * K;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            T v = T(0);
            for (int gg = 0; gg < G; ++gg) v += red[(gg * 4 + c) * TX + tx];
            orow[c * K + t] = v;
        }
    }
}

template <typename T>
int launch(const void* xyzq, const void* row_ptr, const void* src_idx,
           void* out, int nl_t, int K, int nl_src, double eps2,
           void* stream) {
    if (nl_t <= 0 || K <= 0) return (int)cudaSuccess;
    int TX = ((K + 31) / 32) * 32;
    if (TX > BLOCK) TX = BLOCK;
    const int G = BLOCK / TX;
    const size_t tile_bytes = (size_t)G * K * sizeof(Vec4<T>);
    const size_t red_bytes = (size_t)G * 4 * TX * sizeof(T);
    const size_t smem = tile_bytes > red_bytes ? tile_bytes : red_bytes;
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            p2p_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(nl_t, (K + TX - 1) / TX);
    const dim3 block(TX, G);
    p2p_tile_kernel<T><<<grid, block, smem, (cudaStream_t)stream>>>(
        (const T*)xyzq, (const int*)row_ptr, (const int*)src_idx, (T*)out, K,
        nl_src, (T)eps2);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface.  All pointers are device pointers; the launch goes on
// the given stream, allocates nothing and does not synchronise.  Returns
// cudaGetLastError() (0 on success).
extern "C" int p2p_tile_f32(const void* xyzq, const void* row_ptr,
                            const void* src_idx, void* out, int nl_t, int K,
                            int nl_src, double eps2, void* stream) {
    return launch<float>(xyzq, row_ptr, src_idx, out, nl_t, K, nl_src, eps2,
                         stream);
}

extern "C" int p2p_tile_f64(const void* xyzq, const void* row_ptr,
                            const void* src_idx, void* out, int nl_t, int K,
                            int nl_src, double eps2, void* stream) {
    return launch<double>(xyzq, row_ptr, src_idx, out, nl_t, K, nl_src, eps2,
                         stream);
}
