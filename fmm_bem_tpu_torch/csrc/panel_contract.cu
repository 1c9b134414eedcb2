// Batched chunk-panel contraction for Hopper (sm_90a).
//
// Replaces the TPU kernel fmm_bem_tpu/ops/near_panel.py::_contract_pallas,
// the middle stage of the two-stage near-field route that stores with
// matrix entries (Stokes BEM: 3x3 blocks) take.  For every chunk row c of
// the panel store
//
//     out[c, t] = sum_s A[c, t, s] * x[c, s]
//
// with A [C, KTr, Lb] streamed once and x [C, Lb] the chunk's charge row,
// gathered and zero-padded by the caller.  Dummy chunks are computed like
// any other (their x row is zero).  The kernel neither gathers nor reduces
// over chunks: the caller sums each target leaf's chunk rows afterwards.
//
// What bounds it on this card: bytes.  Every element of A is read once
// and used for one multiply-add, so the least time is A's size over the
// device-memory rate; x and out add Lb + KTr elements per KTr * Lb of A.
//
// Design.  The TPU kernel takes a few chunks per step of a sequential grid
// to fill its fast-memory stage; none of that carries over.  One block per
// (chunk, tile of 64 output rows).  The block stages the chunk's charge
// row in shared memory, in column tiles of at most COL_TILE elements (one
// tile for every store the Stokes path builds), so the row may be of any
// length; each warp owns 8 consecutive output rows and reads them with
// 16-byte streaming loads on consecutive addresses, eight independent
// loads in flight per lane; each lane keeps its partial sums in registers
// across the whole row, so there is one shuffle reduction and one plain
// store per output element.  No atomics: every element of out is written
// exactly once and the bits repeat from run to run.  Offsets into A are
// 64-bit (a Stokes store passes 2^31 elements at about 8 GB).  Two
// persistent designs, register streaming and a ring of bulk copies in
// shared memory, were no faster at the Stokes path's shapes on an NVIDIA
// H100 80GB HBM3 at 700 W (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;          // warps per block
constexpr int RPW = 8;             // output rows per warp
constexpr int ROW_TILE = NWARPS * RPW;
constexpr int SEG = 128;           // columns per warp pass: 32 lanes x 4
constexpr int COL_TILE = 6144;     // staged columns: 24 KB f32, 48 KB f64

__device__ __forceinline__ void load4_stream(const float* p, float (&v)[4]) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4_stream(const double* p, double (&v)[4]) {
    const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
    const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename T>
__global__ void __launch_bounds__(NWARPS * 32)
panel_contract_kernel(const T* __restrict__ A, const T* __restrict__ x,
                      T* __restrict__ out, int KTr, int Lb) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* xs = reinterpret_cast<T*>(smem_raw);  // [min(Lb, COL_TILE)]

    const int64_t c = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row0 = blockIdx.y * ROW_TILE + warp * RPW;
    const T* Ac = A + c * (int64_t)KTr * Lb;
    const T* xc = x + c * (int64_t)Lb;

    T acc[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) acc[r] = T(0);

    for (int col0 = 0; col0 < Lb; col0 += COL_TILE) {
        const int ncol = min(COL_TILE, Lb - col0);  // a multiple of SEG
        if (col0 > 0) __syncthreads();  // the previous tile is read out
        for (int i = threadIdx.x * 4; i < ncol; i += NWARPS * 32 * 4) {
            T v[4];
            load4_stream(xc + col0 + i, v);
            xs[i] = v[0]; xs[i + 1] = v[1]; xs[i + 2] = v[2]; xs[i + 3] = v[3];
        }
        __syncthreads();
        for (int s = 0; s < ncol; s += SEG) {
            const int col = s + lane * 4;
            T a[RPW][4];
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                if (row0 + r < KTr) {
                    load4_stream(Ac + (int64_t)(row0 + r) * Lb + col0 + col,
                                 a[r]);
                } else {
                    a[r][0] = a[r][1] = a[r][2] = a[r][3] = T(0);
                }
            }
            const T x0 = xs[col], x1 = xs[col + 1], x2 = xs[col + 2],
                    x3 = xs[col + 3];
#pragma unroll
            for (int r = 0; r < RPW; ++r)
                acc[r] += a[r][0] * x0 + a[r][1] * x1 + a[r][2] * x2 +
                          a[r][3] * x3;
        }
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        T v = acc[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0 && row0 + r < KTr) out[c * (int64_t)KTr + row0 + r] = v;
    }
}

template <typename T>
int launch(const void* A, const void* x, void* out, int C, int KTr, int Lb,
           void* stream) {
    if (C <= 0 || KTr <= 0) return (int)cudaSuccess;
    if (Lb <= 0 || Lb % SEG != 0) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(Lb < COL_TILE ? Lb : COL_TILE) * sizeof(T);
    const dim3 grid(C, (KTr + ROW_TILE - 1) / ROW_TILE);
    panel_contract_kernel<T><<<grid, NWARPS * 32, smem, (cudaStream_t)stream>>>(
        (const T*)A, (const T*)x, (T*)out, KTr, Lb);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface.  All pointers are device pointers; the launch goes on
// the given stream, allocates nothing and does not synchronise.  Returns
// cudaGetLastError() (0 on success).
extern "C" int panel_contract_f32(const void* A, const void* x, void* out,
                                  int C, int KTr, int Lb, void* stream) {
    return launch<float>(A, x, out, C, KTr, Lb, stream);
}

extern "C" int panel_contract_f64(const void* A, const void* x, void* out,
                                  int C, int KTr, int Lb, void* stream) {
    return launch<double>(A, x, out, C, KTr, Lb, stream);
}
