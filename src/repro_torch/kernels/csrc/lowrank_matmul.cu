// lowrank_matmul: y = (x @ A) @ B, the serving hot path of a compressed linear.
//
// Replaces the TPU kernel repro/kernels/lowrank_matmul.py::lowrank_matmul_pallas
// (kernel lowrank_matmul_kernel, pallas_call at :174), with its numerics:
// t = x @ A accumulates in fp32 and is rounded to x's dtype, then y = t @ B
// accumulates in fp32 and is written in x's dtype.
//
// What bounds it on the H100: at decode (M = batch = 4) the work is the
// bytes of the two factors — w_gate at alpha 0.3 is A 2048x615 plus
// B 615x8192 in bf16, 12.6 MB, about 3.8 us at 3.35 TB/s — and at prefill
// (M = 1024) it is a GEMM pair of ~13 GFLOP.  The TPU kernel kept t in VMEM
// and all of B resident there; B does not fit in a Hopper SM's 227 KB, and
// a block that recomputed t for each N tile would re-read all of A once per
// tile (128 times for w_gate).  So the two stages run as separate launches
// on one stream, t (M x r: 5 KB at decode, 1.3 MB at prefill) going
// through a scratch buffer that stays in the 50 MB L2, each factor read
// once per call:
//   * M <= 8 (decode): the split-K skinny path of gemm_tile.cuh, so that
//     both stages spread the factor bytes over ~260 blocks (a partial pass
//     and a fixed-order reduction pass per stage);
//   * larger M (prefill): the 64x64 WMMA tiles of gemm_tile.cuh.
// Any rank is accepted (r is masked, N is tiled), including the break-even
// cap of 1638 for 2048x8192.
#include "gemm_tile.cuh"

namespace {

template <typename T, typename TileLaunch>
int lowrank(TileLaunch tiles, const void* x, const void* A, const void* B, void* t, void* ws, void* y, int M, int K,
            int r, int N, int ldx, int lda, int ldt, int ldb, int ldy, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    if (M <= repro::SKINNY_MAX_M) {
        e = repro::launch_gemm_skinny<T, T>(x, A, t, ws, M, r, K, ldx, lda, ldt, s);
        if (e != cudaSuccess) return e;
        return repro::launch_gemm_skinny<T, T>(t, B, y, ws, M, N, r, ldt, ldb, ldy, s);
    }
    // a function pointer carries no default arguments: a stack of one
    e = tiles(x, A, t, M, r, K, ldx, lda, ldt, false, s, 1, 0, 0, 0);
    if (e != cudaSuccess) return e;
    return tiles(t, B, y, M, N, r, ldt, ldb, ldy, false, s, 1, 0, 0, 0);
}

template <typename T>
long long workspace_bytes(int M, int K, int r, int N) {
    if (M > repro::SKINNY_MAX_M) return 0;
    size_t a = repro::skinny_workspace_bytes<T>(M, r, K), b = repro::skinny_workspace_bytes<T>(M, N, r);
    return (long long)(a > b ? a : b);
}

}  // namespace

// fp32 workspace the call needs (0 above the skinny-M threshold)
REPRO_EXPORT long long lowrank_matmul_workspace_bytes(int M, int K, int r, int N, int elem_bytes) {
    return elem_bytes == 2 ? workspace_bytes<__nv_bfloat16>(M, K, r, N) : workspace_bytes<float>(M, K, r, N);
}

REPRO_EXPORT int lowrank_matmul_bf16(const void* x, const void* A, const void* B, void* t, void* ws, void* y, int M,
                                     int K, int r, int N, int ldx, int lda, int ldt, int ldb, int ldy, void* stream) {
    return lowrank<__nv_bfloat16>(repro::launch_gemm_bf16<__nv_bfloat16>, x, A, B, t, ws, y, M, K, r, N, ldx, lda,
                                  ldt, ldb, ldy, stream);
}

REPRO_EXPORT int lowrank_matmul_f32(const void* x, const void* A, const void* B, void* t, void* ws, void* y, int M,
                                    int K, int r, int N, int ldx, int lda, int ldt, int ldb, int ldy, void* stream) {
    return lowrank<float>(repro::launch_gemm_f32, x, A, B, t, ws, y, M, K, r, N, ldx, lda, ldt, ldb, ldy, stream);
}
