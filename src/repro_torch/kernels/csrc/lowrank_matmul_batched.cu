// lowrank_matmul_batched: y[l] = (x[l] @ A[l]) @ B[l] over a stack of L
// independent low-rank linears — every RSI-compressed expert of a MoE layer
// in one call.
//
// Replaces the TPU kernel
// repro/kernels/lowrank_matmul.py::lowrank_matmul_batched_pallas (kernel
// lowrank_matmul_batched_kernel, pallas_call at :229), with its numerics:
// t = x[l] @ A[l] accumulates in fp32 and is rounded to x's dtype, then
// y[l] = t @ B[l] accumulates in fp32 and is written in x's dtype.
//
// What bounds it on the H100: the factor bytes of the experts that have
// work.  At the MoE decode shape of phi3.5-moe (16 experts, capacity C = 128
// rows each, 4096 -> rank 1229 -> 6400 in bf16) the whole stack is A 161 MB
// and B 252 MB, but 8 tokens x top-2 fill ~16 of the 2048 capacity rows,
// and only the ~10 experts they reach need their factors read (26 MB each,
// ~8 us at 3.35 TB/s).  The TPU kernel kept B[l] resident in VMEM and t in
// a VMEM scratch per grid step; neither fits a Hopper SM's 227 KB at these
// ranks.  So the call is three launches on one stream:
// * a liveness pass: one flag per (expert l, 64-row granule g, 512-column
//   part p) says whether x[l]'s rows [64 g, 64 g + 64) hold any nonzero
//   element in that part (sign ignored: -0.0 is zero).  It reads x once
//   (16.8 MB at the decode shape) and nothing is read back to the host;
// * the two stages, each one launch of gemm_wgmma.cuh's wgmma + TMA GEMM
//   over the whole stack (3-D tensor maps read each operand in place
//   through its row and stack strides), on the plan's tile and k-split
//   (kernels/lowrank_matmul.py::batched_plans, a function of the shapes and
//   the SM count alone, so a captured graph replays the same launch
//   whatever the routing).  At C <= 128 one 128-row tile covers an expert's
//   whole capacity, so each live expert's factors cross from DRAM once.  A
//   tile whose granules are all dead loads nothing and writes zeros; the
//   flags of stage 1 serve stage 2 (a dead row of x gives a zero row of t).
//   t goes through an (L, M, r) scratch in x's dtype.
// The finite-factor contract: the MoE caller (models/moe.py) fills each
// expert's capacity rows from 0 and leaves exact zeros past its count; for
// finite factors a zero row of x gives an exactly zero row of t and of y,
// so writing zeros for a dead tile is the product's own result, and a live
// row's bits do not depend on which tiles are live.  Factors holding inf or
// NaN would give NaN rows where this gives zeros.
//
// Operands may be strided views: the factors of a compressed (L, E, K, r)
// leaf are stored with rows padded to a multiple of 8 elements (r = 1229 is
// stored at row stride 1232), and one layer's (E, K, r) slice is such a
// view, read in place with its row stride and stack stride.  TMA needs the
// bases and strides on 16 bytes: the wrapper copies any other operand into
// aligned rows first (and counts it).  The fp32 entry runs gemm_tile.cuh's
// FMA tiles over the whole stack, without the liveness pass.
#include "gemm_tile.cuh"
#include "gemm_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int LIVE_COLS = 512;  // columns of x one block of the liveness pass scans
constexpr int LIVE_THREADS = 256;

// Grid (parts, granules, L): flags[(l * granules + g) * parts + p].
__global__ void __launch_bounds__(LIVE_THREADS)
live_rows_kernel(const bf16* __restrict__ x, uint8_t* __restrict__ flags, int M, int K, int ldx, long long sx,
                 bool vec) {
    const int p = blockIdx.x, g = blockIdx.y, l = blockIdx.z;
    const int r0 = g * repro::wg::GRANULE, c0 = p * LIVE_COLS;
    const int rows = min(repro::wg::GRANULE, M - r0), cols = min(LIVE_COLS, K - c0);
    const bf16* base = x + l * sx + (size_t)r0 * ldx + c0;
    const int per_row = (cols + 7) / 8;  // 16-byte chunks a row
    unsigned any = 0;
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * per_row; i += LIVE_THREADS) {
        const uint4 v = repro::load_chunk<bf16>(base, ldx, rows, cols, i / per_row, (i % per_row) * 8, vec);
        any |= (v.x | v.y | v.z | v.w) & 0x7fff7fffu;
    }
    any = __syncthreads_or(any != 0);
    if (threadIdx.x == 0) flags[((size_t)l * gridDim.y + g) * gridDim.x + p] = any ? 1 : 0;
}

}  // namespace

// bf16 operands with 16-byte aligned bases, row strides and stack strides (the wrapper ensures
// it); flags: L x ceil(M / 64) x ceil(K / 512) bytes of scratch; (bm1, bn1, s1) and
// (bm2, bn2, s2) the two stages' plans
REPRO_EXPORT int lowrank_matmul_batched_bf16(const void* x, const void* A, const void* B, void* t, void* y,
                                             void* flags, int L, int M, int K, int r, int N, int ldx, int lda,
                                             int ldt, int ldb, int ldy, long long sx, long long sa, long long st,
                                             long long sb, long long sy, int bm1, int bn1, int s1, int bm2, int bn2,
                                             int s2, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (L <= 0 || M <= 0 || N <= 0) return cudaSuccess;
    if (K <= 0 || r <= 0)  // an empty sum: zeros (y is the wrapper's padded stack, sy = M x ldy)
        return cudaMemsetAsync(y, 0, (size_t)L * sy * 2, s);
    const int granules = (M + repro::wg::GRANULE - 1) / repro::wg::GRANULE;
    const int parts = (K + LIVE_COLS - 1) / LIVE_COLS;
    if (granules > 65535 || L > 65535) return cudaErrorInvalidValue;
    const uint8_t* live = static_cast<const uint8_t*>(flags);
    live_rows_kernel<<<dim3(parts, granules, L), LIVE_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<uint8_t*>(flags), M, K, ldx, sx, repro::vec_ok(x, ldx, 2, sx));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = repro::wg::launch_tile<false, bf16, true>(bm1, bn1, x, A, t, M, r, K, ldx, lda, ldt, L, sx, sa, st, s1,
                                                  live, parts, s);
    if (e != cudaSuccess) return e;
    return repro::wg::launch_tile<false, bf16, true>(bm2, bn2, t, B, y, M, N, r, ldt, ldb, ldy, L, st, sb, sy, s2,
                                                     live, parts, s);
}

REPRO_EXPORT int lowrank_matmul_batched_f32(const void* x, const void* A, const void* B, void* t, void* y, int L,
                                            int M, int K, int r, int N, int ldx, int lda, int ldt, int ldb, int ldy,
                                            long long sx, long long sa, long long st, long long sb, long long sy,
                                            void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = repro::launch_gemm_f32(x, A, t, M, r, K, ldx, lda, ldt, false, s, L, sx, sa, st);
    if (e != cudaSuccess) return e;
    return repro::launch_gemm_f32(t, B, y, M, N, r, ldt, ldb, ldy, false, s, L, st, sb, sy);
}
