// Cached near-field leaf-panel product for Hopper (sm_90a).
//
// Replaces the TPU kernel fmm_bem_tpu/ops/near_panel.py::_contract_pallas_fused.
// For every chunk row c of the panel store
//
//     out[chunk_tgt[c], :] += A[c, :, :m0*KSc] . concat_j ql[pidx[c, j], :]
//
// with A [C, KTr, Lb] streamed once, the m0 source-leaf charge tiles of a
// chunk fetched by index inside the kernel (pidx == nl_src is the zero
// tile), and all chunks of a target leaf reduced inside the kernel.
//
// What bounds it on this card: bytes.  Every element of A is read once
// and used for one multiply-add, so the least time is A's size over the
// device-memory rate; charges, indices and the result are a few percent
// of that traffic and the charges stay in L2.
//
// Design.  The TPU kernel walks the chunks on a sequential grid and
// accumulates into a leaf buffer resident in fast memory; here blocks run
// in parallel and nothing carries over between them.  Chunks are sorted
// by target leaf, so a row pointer over chunk_tgt gives each leaf a
// contiguous chunk range: one block per (target leaf, tile of 64 output
// rows) loops over that range.  Per chunk the block stages the gathered
// charge row in shared memory (double-buffered, one barrier per chunk);
// each warp owns 8 consecutive output rows and reads them with 16-byte
// loads on consecutive addresses, eight independent loads in flight per
// lane; each lane keeps its partial sums in registers ACROSS chunks, so
// there is one shuffle reduction and one plain store per output row at
// the end.  No atomics: the result is the same from run to run, every
// output element is written exactly once (leaves without chunks get 0),
// and there is no size limit on the charge table or the leaf count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;          // warps per block
constexpr int RPW = 8;             // output rows per warp
constexpr int ROW_TILE = NWARPS * RPW;
constexpr int SEG = 128;           // columns per warp pass: 32 lanes x 4

__device__ __forceinline__ void load4_stream(const float* p, float (&v)[4]) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4_stream(const double* p, double (&v)[4]) {
    const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
    const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Stage chunk c's charge row: xs[j*KSc + k] = ql[pidx[c, j], k], zero for
// the dummy tile and for the pad columns m0*KSc .. Lb.
template <typename T>
__device__ __forceinline__ void stage_charges(
    T* xs, const T* __restrict__ ql, const int* __restrict__ pidx,
    int64_t c, int m0, int KSc, int Lb, int nl_src) {
    const int mS = m0 * KSc;
    for (int i = threadIdx.x; i < Lb; i += blockDim.x) {
        T v = T(0);
        if (i < mS) {
            const int j = i / KSc;
            const int p = pidx[c * m0 + j];
            if (p >= 0 && p < nl_src) v = ql[(int64_t)p * KSc + (i - j * KSc)];
        }
        xs[i] = v;
    }
}

template <typename T>
__global__ void __launch_bounds__(NWARPS * 32)
near_panel_kernel(const T* __restrict__ A, const int* __restrict__ pidx,
                  const int* __restrict__ row_ptr, const T* __restrict__ ql,
                  T* __restrict__ out, int KTr, int Lb, int m0, int KSc,
                  int nl_src) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* xs = reinterpret_cast<T*>(smem_raw);  // [2][Lb]

    const int leaf = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row0 = blockIdx.y * ROW_TILE + warp * RPW;
    const int c_begin = row_ptr[leaf];
    const int c_end = row_ptr[leaf + 1];

    T acc[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) acc[r] = T(0);

    if (c_begin < c_end)
        stage_charges(xs, ql, pidx, c_begin, m0, KSc, Lb, nl_src);
    __syncthreads();

    for (int c = c_begin; c < c_end; ++c) {
        const int buf = (c - c_begin) & 1;
        // the other buffer was last read before the previous barrier
        if (c + 1 < c_end)
            stage_charges(xs + (buf ^ 1) * Lb, ql, pidx, c + 1, m0, KSc, Lb,
                          nl_src);
        const T* xrow = xs + buf * Lb;
        const T* Ac = A + (int64_t)c * KTr * Lb;
        for (int s = 0; s < Lb; s += SEG) {
            const int col = s + lane * 4;
            T a[RPW][4];
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                if (row0 + r < KTr) {
                    load4_stream(Ac + (int64_t)(row0 + r) * Lb + col, a[r]);
                } else {
                    a[r][0] = a[r][1] = a[r][2] = a[r][3] = T(0);
                }
            }
            const T x0 = xrow[col], x1 = xrow[col + 1], x2 = xrow[col + 2],
                    x3 = xrow[col + 3];
#pragma unroll
            for (int r = 0; r < RPW; ++r)
                acc[r] += a[r][0] * x0 + a[r][1] * x1 + a[r][2] * x2 +
                          a[r][3] * x3;
        }
        __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        T v = acc[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0 && row0 + r < KTr)
            out[(int64_t)leaf * KTr + row0 + r] = v;
    }
}

template <typename T>
int launch(const void* A, const void* pidx, const void* row_ptr,
           const void* ql, void* out, int nl_t, int KTr, int Lb, int m0,
           int KSc, int nl_src, void* stream) {
    if (nl_t <= 0 || KTr <= 0) return (int)cudaSuccess;
    if (Lb % SEG != 0 || m0 * KSc > Lb) return (int)cudaErrorInvalidValue;
    const size_t smem = 2 * (size_t)Lb * sizeof(T);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            near_panel_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(nl_t, (KTr + ROW_TILE - 1) / ROW_TILE);
    near_panel_kernel<T><<<grid, NWARPS * 32, smem, (cudaStream_t)stream>>>(
        (const T*)A, (const int*)pidx, (const int*)row_ptr, (const T*)ql,
        (T*)out, KTr, Lb, m0, KSc, nl_src);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface.  All pointers are device pointers; the launch goes on
// the given stream, allocates nothing and does not synchronise.  Returns
// cudaGetLastError() (0 on success).
extern "C" int near_panel_f32(const void* A, const void* pidx,
                              const void* row_ptr, const void* ql, void* out,
                              int nl_t, int KTr, int Lb, int m0, int KSc,
                              int nl_src, void* stream) {
    return launch<float>(A, pidx, row_ptr, ql, out, nl_t, KTr, Lb, m0, KSc,
                         nl_src, stream);
}

extern "C" int near_panel_f64(const void* A, const void* pidx,
                              const void* row_ptr, const void* ql, void* out,
                              int nl_t, int KTr, int Lb, int m0, int KSc,
                              int nl_src, void* stream) {
    return launch<double>(A, pidx, row_ptr, ql, out, nl_t, KTr, Lb, m0, KSc,
                          nl_src, stream);
}
