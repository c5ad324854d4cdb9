// sketch_matmul: C = op(A) @ B with an fp32 accumulator, op(A) = A or A^T.
//
// Replaces the TPU kernel repro/kernels/sketch_matmul.py::sketch_matmul_pallas
// (kernel sketch_matmul_kernel, pallas_call at :77), and does what that
// file's docstring claims but its wrapper does not: the transposed operand
// of RSI's W^T @ X is read in place (TRANS_A), so W^T is never materialized.
//
// What bounds it on the H100: at RSI's shapes (W 2048x8192 bf16 times a
// skinny 8192x615 sketch) the product is 20.6 GFLOP against 34 MB of
// operands, far above the card's ~295 FLOP/byte ridge, so it is bound by
// tensor-core operations (about 21 us at 989 TFLOP/s).  The design keeps
// the tensor cores fed with WMMA bf16 tiles (gemm_tile.cuh): 64x64 output
// tiles give 320 blocks at these shapes, enough to cover all 132 SMs
// without a split-K pass.  It reaches a fraction of the peak only — no TMA,
// no wgmma, no multi-stage pipeline; those are later work.
//
// The same entry with an fp32 output serves the tied-embedding logits
// (embed @ x^T, fp32 out, never rounded to bf16), which are bound by the
// 525 MB read of the embedding.
#include "gemm_tile.cuh"

REPRO_EXPORT int sketch_matmul_bf16(const void* a, const void* b, void* c, int M, int N, int K, int lda, int ldb,
                                    int ldc, int trans_a, void* stream) {
    return repro::launch_gemm_bf16<__nv_bfloat16>(a, b, c, M, N, K, lda, ldb, ldc, trans_a != 0,
                                                  static_cast<cudaStream_t>(stream));
}

REPRO_EXPORT int sketch_matmul_bf16_f32out(const void* a, const void* b, void* c, int M, int N, int K, int lda,
                                           int ldb, int ldc, int trans_a, void* stream) {
    return repro::launch_gemm_bf16<float>(a, b, c, M, N, K, lda, ldb, ldc, trans_a != 0,
                                          static_cast<cudaStream_t>(stream));
}

REPRO_EXPORT int sketch_matmul_f32(const void* a, const void* b, void* c, int M, int N, int K, int lda, int ldb,
                                   int ldc, int trans_a, void* stream) {
    return repro::launch_gemm_f32(a, b, c, M, N, K, lda, ldb, ldc, trans_a != 0, static_cast<cudaStream_t>(stream));
}
