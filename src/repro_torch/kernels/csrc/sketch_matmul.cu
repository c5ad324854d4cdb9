// sketch_matmul: C = op(A) @ B with an fp32 accumulator, op(A) = A or A^T.
//
// Replaces the TPU kernel repro/kernels/sketch_matmul.py::sketch_matmul_pallas
// (kernel sketch_matmul_kernel, pallas_call at :77), and does what that
// file's docstring claims but its wrapper does not: the transposed operand
// of RSI's W^T @ X is read in place, so W^T is never materialized.
//
// What bounds it on the H100: at RSI's shapes (W 2048x8192 bf16 times a
// skinny 8192x615 sketch, or W^T 8192x2048 times 2048x615) the product is
// 20.6 GFLOP against 34-44 MB of operands, far above the card's ~295
// FLOP/byte ridge, so it is bound by tensor-core operations (20.9 us at 989
// TFLOP/s).  The tied-embedding logits (embed 128256x2048 @ x^T 2048xB, B
// <= 8, fp32 out, never rounded) are bound by the 525 MB read of the
// embedding (157 us at 3.35 TB/s); an untied (d, V) head's logits, which
// runtime/dispatch.py passes as head^T @ x^T (the head is the tall A side
// under trans_a), by the read of the head (phi3.5-moe: 263 MB, 79 us).
//
// The bf16 entries (bf16 or fp32 out) run the wgmma + TMA GEMM of
// gemm_wgmma.cuh (sm_90a: a TMA ring fed by a producer warpgroup, two
// consumer warpgroups on wgmma, split-K partials summed in cluster-rank
// order through distributed shared memory), with this file's plan:
// * Tiles are 256 x 160 where N > 64 and 128 x 64 for the logits (N <= 64).
//   The bytes a tile brings in per flop, not the tensor cores, set the pace
//   at RSI's shapes: the larger the tile, the less of W and Y crosses from
//   L2 to the SMs.  Where the tiles alone would leave SMs idle, K is split
//   over a cluster of up to 4 blocks; the split counts waves over the blocks
//   the card holds at once in clusters of that size
//   (cudaOccupancyMaxActiveClusters).  What each main-path shape launches
//   on the H100's 132 SMs: plain 2048x615 @ K 8192: 8 x 4 tiles x 3 splits
//   = 96 blocks (clusters of 3, 42-43 k-blocks each); trans_a 8192x615 @
//   K 2048: 32 x 4 tiles = 128 blocks, no split; the logits 128256 x B: 1002
//   blocks of 128 x 64, two an SM; the untied head 32064 x B (trans_a, K
//   4096): 251 blocks of 128 x 64, no split.  A few rows times a wide N
//   would fill 256-row tiles mostly with zeros: callers pass such a product
//   transposed.
// * TMA needs 16-byte aligned bases and row strides: the Python wrapper
//   copies any other operand into aligned rows first (and counts it).
//
// The fp32 entry keeps gemm_tile.cuh's FMA kernel: tensor cores would take
// fp32 through TF32, which breaks the fp32 tolerance (1e-4) the reference's
// fp32 products are held to.
#include "gemm_tile.cuh"
#include "gemm_wgmma.cuh"

namespace {

namespace wg = repro::wg;

constexpr int SKETCH_MAX_SPLITS = 4;  // k-splits this file's plan considers

// The split (<= 4, >= 8 k-blocks each) with the fewest waves x (k-blocks per block + 8),
// the 8 standing for a block's fixed cost (filling the ring, the epilogue), waves
// counted over the blocks the card holds at once in clusters of that size.
template <class Cf, bool TRANS_A, typename OutT>
int launch_planned(const void* a, const void* b, void* c, int M, int N, int K, int lda, int ldb, int ldc,
                   cudaStream_t stream) {
    const int mt = (M + Cf::BM - 1) / Cf::BM, nt = (N + Cf::BN - 1) / Cf::BN, nk = (K + wg::BK - 1) / wg::BK;
    int splits = 1;
    long long best = -1;
    for (int s = 1; s <= SKETCH_MAX_SPLITS; ++s) {
        if (s > 1 && nk / s < 8) break;
        const int slots = wg::resident_blocks<Cf, TRANS_A, OutT>(s);
        if (slots <= 0) continue;
        const long long waves = ((long long)mt * nt * s + slots - 1) / slots;
        const long long cost = waves * ((nk + s - 1) / s + 8);
        if (best < 0 || cost < best) splits = s, best = cost;
    }
    return wg::launch<Cf, TRANS_A, OutT>(a, b, c, M, N, K, lda, ldb, ldc, 1, 0, 0, 0, splits, nullptr, 0, stream);
}

template <typename OutT>
int launch_bf16(const void* a, const void* b, void* c, int M, int N, int K, int lda, int ldb, int ldc, int trans_a,
                cudaStream_t stream) {
    if (M <= 0 || N <= 0) return cudaSuccess;
    if (K <= 0)  // an empty sum: C = 0 (zero bits in bf16 and fp32)
        return cudaMemset2DAsync(c, (size_t)ldc * sizeof(OutT), 0, (size_t)N * sizeof(OutT), M, stream);
    using Small = wg::Cfg<128, 64>;
    using Large = wg::Cfg<256, 160>;
    if (N <= 64)
        return trans_a ? launch_planned<Small, true, OutT>(a, b, c, M, N, K, lda, ldb, ldc, stream)
                       : launch_planned<Small, false, OutT>(a, b, c, M, N, K, lda, ldb, ldc, stream);
    return trans_a ? launch_planned<Large, true, OutT>(a, b, c, M, N, K, lda, ldb, ldc, stream)
                   : launch_planned<Large, false, OutT>(a, b, c, M, N, K, lda, ldb, ldc, stream);
}

}  // namespace

// bf16 operands with 16-byte aligned bases and row strides (the wrapper ensures it)
REPRO_EXPORT int sketch_matmul_bf16(const void* a, const void* b, void* c, int M, int N, int K, int lda, int ldb,
                                    int ldc, int trans_a, void* stream) {
    return launch_bf16<__nv_bfloat16>(a, b, c, M, N, K, lda, ldb, ldc, trans_a, static_cast<cudaStream_t>(stream));
}

REPRO_EXPORT int sketch_matmul_bf16_f32out(const void* a, const void* b, void* c, int M, int N, int K, int lda,
                                           int ldb, int ldc, int trans_a, void* stream) {
    return launch_bf16<float>(a, b, c, M, N, K, lda, ldb, ldc, trans_a, static_cast<cudaStream_t>(stream));
}

REPRO_EXPORT int sketch_matmul_f32(const void* a, const void* b, void* c, int M, int N, int K, int lda, int ldb,
                                   int ldc, int trans_a, void* stream) {
    return repro::launch_gemm_f32(a, b, c, M, N, K, lda, ldb, ldc, trans_a != 0, static_cast<cudaStream_t>(stream));
}
