// Cached near-field leaf-panel product for Hopper (sm_90a).
//
// Replaces the TPU kernel fmm_bem_tpu/ops/near_panel.py::_contract_pallas_fused.
// For every chunk row c of the panel store
//
//     out[chunk_tgt[c], :] += A[c, :, :m0*KSc] . concat_j ql[pidx[c, j], :]
//
// with A [C, KTr, Lb] streamed once, the m0 source-leaf charge tiles of a
// chunk fetched by index inside the kernel (pidx == nl_src is the zero
// tile), and all chunks of a target leaf reduced on the card.
//
// What bounds it on this card: bytes.  Every element of A it needs is
// read once and used for one multiply-add (0.5 flop per byte in f32,
// 0.25 in f64), so the least time is the real chunks' needed columns
// (the first m0*KSc of each row; the rest of Lb is zero padding) over
// the device-memory rate; charges, indices, carries and the result are a
// few percent of that traffic and the charges stay in L2.  Tensor cores
// do not apply: a matrix-vector product has one column, and at 0.5 flop
// per byte the memory rate asks 1.7 TFLOP/s of f32 cores that give about
// 40 times that.  What the design has to do is keep every SM's loads in
// flight to the end, on the needed bytes only.
//
// Design.  The TPU kernel walks the chunks on a sequential grid and
// carries a leaf's sum in fast memory; one block per target leaf, this
// file's first design, left a leaf of 163 chunks to one SM while the
// others idled.  So the work is cut by chunks, not by leaves: block
// (b, y) takes the S consecutive chunks [b*S, (b+1)*S) of the
// leaf-sorted chunk list and row tile y, and every block streams the
// same bytes whatever the spread of chunks per leaf.  The host picks S
// (ops/near_panel.py::near_tiling) for several blocks per SM and about
// 64 KB of A per block.  A block issues its first chunk's first loads,
// then stages the gathered charge rows of all its chunks in shared
// memory once, behind one barrier, so its chunk loop has no barrier: each
// warp owns 8 consecutive output rows, reads them with 16-byte streaming
// loads on consecutive addresses, and keeps its partial sums in
// registers across chunks.  A row is read only up to its last needed
// 4-column group (Lw = m0*KSc rounded up to 4): lanes past it neither
// load nor multiply, so a store of KS 136 and m0 6 (816 of 896 columns)
// reads no padding.  Where chunk_tgt changes the block flushes
// the finished leaf (a shuffle reduction per row): a leaf whose whole
// chunk range row_ptr[l] .. row_ptr[l+1] lies in the block goes straight
// to out; a leaf cut by the block's first or last edge goes to a carry
// slot carry[b][0 or 1][:].  A second, small launch walks the target
// leaves: a cut leaf sums its carries in block order, a leaf without
// chunks gets 0, and the others were written by the first pass.  No
// atomics: each output element is written exactly once and the sums run
// in a fixed order, so two calls give the same bits.  The first pass
// reads no row pointer: the chunks just before and after a block's range
// say whether its edge leaves are cut, and a block of dummy chunks
// (chunk_tgt == nl_t, sorted last) exits after one round of loads.  The
// second pass is a programmatic dependent launch (Hopper's griddepcontrol),
// so its launch overlaps the first pass's tail.  Rows per block follow
// KTr (ceil(KTr / 8) warps for KTr <= 64, balanced row tiles beyond), so
// a KTr of 50 idles 6 rows of 56, not 14 of 64.
//
// Measured (chip_smoke.py, near_panel_ab.py, PERF.md): the first pass
// reads the stores at about the rate of a plain PyTorch reduction over
// the same needed bytes, so no ring of asynchronous copies was added.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 8;       // warps per block at most
constexpr int RPW = 8;             // output rows per warp
constexpr int SEG = 128;           // columns per warp pass: 32 lanes x 4
constexpr int STAGE_UNROLL = 4;    // charge elements a thread stages at once
constexpr int FIX_THREADS = 256;   // threads per block of the fix-up pass

// Blocks of MAX_WARPS warps each SM holds at once in the first pass: 4
// caps f32 at 64 registers, 2 leaves f64 the 124 it takes without
// spills.
template <typename T> struct ResidentBlocks { static constexpr int value = 4; };
template <> struct ResidentBlocks<double> { static constexpr int value = 2; };

__device__ __forceinline__ void load4_stream(const float* p, float (&v)[4]) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4_stream(const double* p, double (&v)[4]) {
    const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
    const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Reduce each warp's RPW row sums over the lanes and store them at
// dst[row0 + r] (lane 0; rows past KTr are dropped).
template <typename T>
__device__ __forceinline__ void flush_rows(T (&acc)[RPW], T* dst, int row0,
                                           int KTr, int lane) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        T v = acc[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0 && dst != nullptr && row0 + r < KTr) dst[row0 + r] = v;
        acc[r] = T(0);
    }
}

// Where a block's finished leaf goes: its carry slot 0 (the first leaf,
// cut), slot 1 (the last leaf, cut), or its row of out (a leaf of
// nowhere is dropped).
template <typename T>
__device__ __forceinline__ T* leaf_dest(int leaf, int lf, int ll,
                                        bool cut_first, bool cut_last,
                                        T* carry_b, T* out, int nl_t,
                                        int KTr) {
    if (leaf == lf && cut_first) return carry_b;
    if (leaf == ll && cut_last) return carry_b + KTr;
    if (leaf >= 0 && leaf < nl_t) return out + (int64_t)leaf * KTr;
    return nullptr;
}

// The rows row0 .. row0 + RPW of columns col .. col + 4 of one chunk's
// panel Ac (zeros past KTr and past the needed columns Lw), with
// streaming 16-byte loads.
template <typename T>
__device__ __forceinline__ void load_segment(T (&a)[RPW][4], const T* Ac,
                                             int row0, int KTr, int Lb,
                                             int Lw, int col) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
        if (row0 + r < KTr && col < Lw) {
            load4_stream(Ac + (int64_t)(row0 + r) * Lb + col, a[r]);
        } else {
            a[r][0] = a[r][1] = a[r][2] = a[r][3] = T(0);
        }
    }
}

// First pass: block (b, y) contracts the real chunks of [b*S, (b+1)*S)
// for the rows of tile y.
template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32, ResidentBlocks<T>::value)
near_tiles_kernel(const T* __restrict__ A, const int* __restrict__ pidx,
                  const int* __restrict__ chunk_tgt, const T* __restrict__ ql,
                  T* __restrict__ out, T* __restrict__ carry, int nl_t,
                  int KTr, int Lb, int m0, int KSc, int nl_src, int C, int S) {
    // the columns read of each row: the needed ones, in 4-column groups
    const int mS = m0 * KSc;
    const int Lw = (mS + 3) & ~3;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* xs = reinterpret_cast<T*>(smem_raw);  // [S][Lw] charge rows
    // tgt[1 + k] = chunk_tgt[c0 + k]; tgt[0] and tgt[nc + 1] the chunks
    // before and after the range (-1 past either end of the store)
    int* tgt = reinterpret_cast<int*>(xs + (int64_t)S * Lw);  // [S + 2]
    __shared__ int n_real;  // real chunks of the range

    // the fix-up grid may be scheduled once every block of this one has
    // started; it waits for this grid's end before it reads a carry
    asm volatile("griddepcontrol.launch_dependents;");
    const int64_t c0 = (int64_t)blockIdx.x * S;
    const int nc = C - c0 < S ? (int)(C - c0) : S;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row0 = blockIdx.y * (blockDim.x >> 5) * RPW + warp * RPW;

    // the first chunk's first columns are on their way while the block
    // stages its charges
    T a[RPW][4];
    load_segment(a, A + c0 * KTr * Lb, row0, KTr, Lb, Lw, lane * 4);

    // the charge rows, STAGE_UNROLL elements a thread at a time: all
    // their indices, then all their charges, then the stores, so that a
    // thread waits two load latencies per round and not per element
    const int total = nc * Lw;
    for (int i0 = threadIdx.x; i0 < total; i0 += STAGE_UNROLL * blockDim.x) {
        int64_t src[STAGE_UNROLL];  // index into ql, -1 for a zero
#pragma unroll
        for (int u = 0; u < STAGE_UNROLL; ++u) {
            const int i = i0 + u * blockDim.x;
            const int k = i / Lw;
            const int col = i - k * Lw;
            src[u] = -1;
            if (i < total && col < mS) {
                const int j = col / KSc;
                const int p = pidx[(c0 + k) * m0 + j];
                if (p >= 0 && p < nl_src)
                    src[u] = (int64_t)p * KSc + (col - j * KSc);
            }
        }
        T v[STAGE_UNROLL];
#pragma unroll
        for (int u = 0; u < STAGE_UNROLL; ++u)
            v[u] = src[u] >= 0 ? ql[src[u]] : T(0);
#pragma unroll
        for (int u = 0; u < STAGE_UNROLL; ++u) {
            const int i = i0 + u * blockDim.x;
            if (i < total) xs[i] = v[u];
        }
    }
    for (int k = (int)threadIdx.x - 1; k <= nc; k += blockDim.x) {
        const int64_t c = c0 + k;
        const int t = c >= 0 && c < C ? chunk_tgt[c] : -1;
        tgt[k + 1] = t;
        // the last real chunk (dummies sort last) sets the count; with
        // none, the first chunk's thread sets 0
        if (k >= 0 && k < nc) {
            const bool real = t >= 0 && t < nl_t;
            const int64_t cn = c + 1;
            const int tn = k + 1 < nc ? chunk_tgt[cn] : -1;
            if (real && !(tn >= 0 && tn < nl_t)) n_real = k + 1;
            if (k == 0 && !real) n_real = 0;
        }
    }
    __syncthreads();

    const int n = n_real;
    if (n == 0) return;  // dummy chunks only: the whole block
    const int lf = tgt[1], ll = tgt[n], after = tgt[n + 1];
    // a leaf is cut iff its chunks leave [c0, c0 + S); only the block's
    // first and last leaves can be
    const bool cut_first = tgt[0] == lf || after == lf;
    const bool cut_last = after == ll;
    T* carry_b = carry + (int64_t)blockIdx.x * 2 * KTr;

    T acc[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) acc[r] = T(0);
    int cur = lf;
    for (int k = 0; k < n; ++k) {
        const int leaf = tgt[k + 1];
        if (leaf != cur) {  // uniform over the block
            flush_rows(acc, leaf_dest(cur, lf, ll, cut_first, cut_last,
                                      carry_b, out, nl_t, KTr),
                       row0, KTr, lane);
            cur = leaf;
        }
        const T* xrow = xs + (int64_t)k * Lw;
        const T* Ac = A + (c0 + k) * KTr * Lb;
        for (int s = 0; s < Lw; s += SEG) {
            const int col = s + lane * 4;
            if (k > 0 || s > 0) load_segment(a, Ac, row0, KTr, Lb, Lw, col);
            if (col >= Lw) continue;  // padding: nothing to load or add
            const T x0 = xrow[col], x1 = xrow[col + 1], x2 = xrow[col + 2],
                    x3 = xrow[col + 3];
#pragma unroll
            for (int r = 0; r < RPW; ++r)
                acc[r] += a[r][0] * x0 + a[r][1] * x1 + a[r][2] * x2 +
                          a[r][3] * x3;
        }
    }
    flush_rows(acc, leaf_dest(cur, lf, ll, cut_first, cut_last, carry_b, out,
                              nl_t, KTr),
               row0, KTr, lane);
}

// Second pass, one thread per (leaf, row): a leaf without chunks gets 0;
// a leaf cut over blocks b0 .. b1 sums its carries in block order (slot
// 1 of b0 where the leaf starts inside b0, slot 0 of every later block);
// the rest were written by the first pass.  Launched as a programmatic
// dependent of the first pass: it reads the row pointer while that pass
// drains, then waits for it.
template <typename T>
__global__ void __launch_bounds__(FIX_THREADS)
near_fixup_kernel(const int* __restrict__ row_ptr, const T* __restrict__ carry,
                  T* __restrict__ out, int nl_t, int KTr, int C, int S,
                  int nblocks) {
    const int64_t i = (int64_t)blockIdx.x * FIX_THREADS + threadIdx.x;
    const bool live = i < (int64_t)nl_t * KTr;
    const int leaf = live ? (int)(i / KTr) : 0;
    const int row = (int)(i - (int64_t)leaf * KTr);
    const int r0 = live ? max(row_ptr[leaf], 0) : 0;
    const int r1 = live ? min(row_ptr[leaf + 1], C) : 0;
    // the first pass's carries and rows are complete and visible past
    // this point; every thread waits, so this grid cannot end before it
    asm volatile("griddepcontrol.wait;" ::: "memory");
    if (!live) return;
    if (r1 <= r0) {
        out[i] = T(0);
        return;
    }
    const int b0 = r0 / S;
    const int b1 = min((r1 - 1) / S, nblocks - 1);
    if (b0 >= b1) return;
    T v = carry[((int64_t)b0 * 2 + (r0 == b0 * S ? 0 : 1)) * KTr + row];
    for (int b = b0 + 1; b <= b1; ++b) v += carry[(int64_t)b * 2 * KTr + row];
    out[i] = v;
}

template <typename T>
int launch(const void* A, const void* pidx, const void* chunk_tgt,
           const void* row_ptr, const void* ql, void* out, void* carry,
           int nl_t, int KTr, int Lb, int m0, int KSc, int nl_src, int C,
           int S, int warps, void* stream) {
    if (nl_t <= 0 || KTr <= 0) return (int)cudaSuccess;
    if (Lb % SEG != 0 || m0 * KSc > Lb || S < 1 || C < 0 || warps < 1 ||
        warps > MAX_WARPS)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int nblocks = (int)(((int64_t)C + S - 1) / S);
    if (nblocks > 0) {
        const size_t smem = (size_t)S * ((m0 * KSc + 3) & ~3) * sizeof(T) +
                            (size_t)(S + 2) * sizeof(int);
        if (smem > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                near_tiles_kernel<T>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        const int tile_rows = warps * RPW;
        const dim3 grid(nblocks, (KTr + tile_rows - 1) / tile_rows);
        near_tiles_kernel<T><<<grid, warps * 32, smem, st>>>(
            (const T*)A, (const int*)pidx, (const int*)chunk_tgt,
            (const T*)ql, (T*)out, (T*)carry, nl_t, KTr, Lb, m0, KSc, nl_src,
            C, S);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    const int64_t nfix = (int64_t)nl_t * KTr;
    // programmatic dependent launch: the fix-up's launch and scheduling
    // overlap the first pass's last blocks (griddepcontrol above)
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((nfix + FIX_THREADS - 1) / FIX_THREADS));
    cfg.blockDim = dim3(FIX_THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, near_fixup_kernel<T>, (const int*)row_ptr, (const T*)carry,
        (T*)out, nl_t, KTr, C, S, nblocks);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface.  All pointers are device pointers; carry holds
// [ceil(C / S), 2, KTr] elements of the output's type.  The two launches
// go on the given stream, allocate nothing and do not synchronise.
// Returns the first nonzero cudaGetLastError() of the two (0 on success).
extern "C" int near_panel_f32(const void* A, const void* pidx,
                              const void* chunk_tgt, const void* row_ptr,
                              const void* ql, void* out, void* carry,
                              int nl_t, int KTr, int Lb, int m0, int KSc,
                              int nl_src, int C, int S, int warps,
                              void* stream) {
    return launch<float>(A, pidx, chunk_tgt, row_ptr, ql, out, carry, nl_t,
                         KTr, Lb, m0, KSc, nl_src, C, S, warps, stream);
}

extern "C" int near_panel_f64(const void* A, const void* pidx,
                              const void* chunk_tgt, const void* row_ptr,
                              const void* ql, void* out, void* carry,
                              int nl_t, int KTr, int Lb, int m0, int KSc,
                              int nl_src, int C, int S, int warps,
                              void* stream) {
    return launch<double>(A, pidx, chunk_tgt, row_ptr, ql, out, carry, nl_t,
                          KTr, Lb, m0, KSc, nl_src, C, S, warps, stream);
}
