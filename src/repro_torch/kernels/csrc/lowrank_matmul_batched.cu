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
// What bounds it on the H100: the factor bytes.  At the MoE decode shape of
// phi3.5-moe (16 experts, capacity C = 128 rows each, 4096 -> rank 1229 ->
// 6400 in bf16) one call reads A 161 MB and B 252 MB for 53 GFLOP, ~115
// FLOP per byte, well under the card's ~295 ridge: 0.136 ms at 3.35 TB/s.
// The TPU kernel kept B[l] resident in VMEM and t in a VMEM scratch per
// grid step; neither fits a Hopper SM's 227 KB at these ranks, and a block
// that recomputed t per N tile would re-read A[l] once per tile.  So, as in
// lowrank_matmul.cu, the two stages are two launches on one stream, each
// over the WHOLE stack: the 64x64 WMMA tiles of gemm_tile.cuh on a grid of
// (N / 64, M / 64, L), each block offsetting its operands by its stack index
// blockIdx.z and the per-operand stack strides.  t goes through an
// (L, M, r) scratch in x's dtype (5 MB at the decode shape, inside the
// 50 MB L2).  There is no residency budget (the TPU kernel's _check_fits):
// any M, K, r and N.
//
// Operands may be strided views: the factors of a compressed (L, E, K, r)
// leaf are stored with rows padded to a multiple of 8 elements (r = 1229 is
// stored at row stride 1232), and one layer's (E, K, r) slice is such a
// view, read in place with its row stride and stack stride.
//
// No split-K path: the MoE caller's M is the expert capacity, which
// moe_capacity rounds up to at least 128 rows, so the tiles always have
// rows to fill (the skinny M <= 8 decode path of the 2-D kernel is not
// needed here).  A smaller M is computed correctly, on mostly empty tiles.
#include "gemm_tile.cuh"

namespace {

template <typename TileLaunch>
int batched(TileLaunch tiles, const void* x, const void* A, const void* B, void* t, void* y, int L, int M, int K,
            int r, int N, int ldx, int lda, int ldt, int ldb, int ldy, long long sx, long long sa, long long st,
            long long sb, long long sy, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = tiles(x, A, t, M, r, K, ldx, lda, ldt, false, s, L, sx, sa, st);
    if (e != cudaSuccess) return e;
    return tiles(t, B, y, M, N, r, ldt, ldb, ldy, false, s, L, st, sb, sy);
}

}  // namespace

REPRO_EXPORT int lowrank_matmul_batched_bf16(const void* x, const void* A, const void* B, void* t, void* y, int L,
                                             int M, int K, int r, int N, int ldx, int lda, int ldt, int ldb, int ldy,
                                             long long sx, long long sa, long long st, long long sb, long long sy,
                                             void* stream) {
    return batched(repro::launch_gemm_bf16<__nv_bfloat16>, x, A, B, t, y, L, M, K, r, N, ldx, lda, ldt, ldb, ldy,
                   sx, sa, st, sb, sy, stream);
}

REPRO_EXPORT int lowrank_matmul_batched_f32(const void* x, const void* A, const void* B, void* t, void* y, int L,
                                            int M, int K, int r, int N, int ldx, int lda, int ldt, int ldb, int ldy,
                                            long long sx, long long sa, long long st, long long sb, long long sy,
                                            void* stream) {
    return batched(repro::launch_gemm_f32, x, A, B, t, y, L, M, K, r, N, ldx, lda, ldt, ldb, ldy, sx, sa, st, sb, sy,
                   stream);
}
