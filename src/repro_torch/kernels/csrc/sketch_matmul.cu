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
// The bf16 entries (bf16 or fp32 out) run a Hopper kernel (sm_90a):
// * TMA loads A and B tiles into a ring of four shared-memory stages guarded
//   by mbarriers; one thread of a producer warpgroup keeps the ring full
//   (the warpgroup hands its registers to the consumers, setmaxnreg) while
//   two consumer warpgroups issue wgmma (bf16 in, fp32 accumulate in
//   registers) on the tiles that have arrived, one k-block's products in
//   flight behind the next.
// * A is K-major, or under trans_a MN-major: the TMA boxes cover the stored
//   (K, M) matrix and the descriptor's transpose bit reads it as A^T.  B is
//   the stored (K, N) row-major matrix, MN-major with the transpose bit,
//   loaded as 32- or 64-column boxes (64- or 128-byte swizzle).
// * Tiles are 256 x 160 where N > 64 (each consumer warpgroup two
//   m64n160k16 accumulators: 160 registers a thread) and 128 x 64 for the
//   logits (N <= 64).  The bytes a tile brings in per flop, not the tensor
//   cores, set the pace at RSI's shapes: the larger the tile, the less of
//   W and Y crosses from L2 to the SMs.  Where the tiles alone would leave
//   SMs idle, K is split over a cluster of up to 4 blocks along gridDim.z;
//   after the main loop each block parks its fp32 partial tile in its own
//   shared memory and sums one row slice of the tile over the cluster's
//   partials through distributed shared memory, always in cluster-rank
//   order, so the result is the same bits on every launch (no atomics, no
//   second pass).  The split counts waves over the blocks the card holds at
//   once in clusters of that size (cudaOccupancyMaxActiveClusters).  What
//   each main-path shape launches on the H100's 132 SMs: plain 2048x615 @
//   K 8192: 8 x 4 tiles x 3 splits = 96 blocks (clusters of 3, 42-43
//   k-blocks each); trans_a 8192x615 @ K 2048: 32 x 4 tiles = 128 blocks, no
//   split; the logits 128256 x B: 1002 blocks of 128 x 64, two an SM; the
//   untied head 32064 x B (trans_a, K 4096): 251 blocks of 128 x 64, no
//   split.  A few rows times a wide N would fill 256-row tiles mostly with
//   zeros: callers pass such a product transposed.
// * The epilogue goes through shared memory (the ring, free by then) and
//   writes C with 16-byte (fp32) or 8-byte (bf16) stores, cut at the ragged
//   M and N edges; TMA zero-fills the ragged edges of the loads.
// * TMA needs 16-byte aligned bases and row strides: the Python wrapper
//   copies any other operand into aligned rows first (and counts it).
//   Tensor maps are encoded on the host per call and passed as
//   __grid_constant__ parameters, so a captured CUDA graph replays them
//   over its fixed buffers.
//
// The fp32 entry keeps gemm_tile.cuh's FMA kernel: tensor cores would take
// fp32 through TF32, which breaks the fp32 tolerance (1e-4) the reference's
// fp32 products are held to.
#include <atomic>

#include "gemm_tile.cuh"
#include "hopper.cuh"

namespace {

using namespace repro::hopper;

constexpr int BK = 64;                         // k-block: one 128-byte swizzle row of bf16
constexpr int CONSUMERS = 2;                   // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + a producer warpgroup (one thread of it issues the loads)
constexpr int MAX_SPLITS = 4;                  // k-splits of a tile: the blocks of a cluster
constexpr int CHUNK = 64 * BK * 2;             // one 64-row (or 64-column) TMA box of a k-block of A: 8 KB

// A block's tile is BM x BN: each consumer warpgroup owns MI row tiles of 64
// (MI wgmma accumulators of 64 x BN).  B's tile is BN / BW boxes of BW
// columns, swizzled by BW * 2 bytes.  BN is 160 (N > 64) or 64.
template <int BN>
struct Cfg {
    static constexpr int MI = BN == 64 ? 1 : 2;
    static constexpr int BM = CONSUMERS * 64 * MI;  // 128 or 256
    static constexpr int BW = BN % 64 == 0 ? 64 : 32;
    static constexpr int B_SW = BW * 2;              // 128 or 64 bytes
    static constexpr int B_BOX = BK * BW * 2;        // bytes of one B box
    static constexpr int STAGES = 4;
    static constexpr int A_BYTES = BM * BK * 2;  // 16 or 32 KB
    static constexpr int B_BYTES = BK * BN * 2;  // 8 or 20 KB
    static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
    static constexpr int CLD = BN + 4;  // row stride of the fp32 epilogue tile
    static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring to 1024 bytes
    static constexpr int PER_SM = BN == 64 ? 2 : 1;           // blocks an SM holds (shared memory)
    // registers a thread after the producer warpgroup hands its registers to the consumers
    // (one block an SM: 384 threads start at 168; 128 x 40 + 256 x 232 <= 65536), 0: no hand-over
    static constexpr int PRODUCER_REGS = PER_SM == 1 ? 40 : 0;
    static constexpr int CONSUMER_REGS = PER_SM == 1 ? 232 : 0;
    static_assert(BN % BW == 0, "B's tile is whole boxes");
    static_assert(BM * CLD * 4 <= STAGES * STAGE_BYTES, "the epilogue tile must fit in the ring");
};

// A barrier over the consumer warpgroups (threads 0-255) alone.
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory"); }

template <typename OutT>
__device__ __forceinline__ void store4(OutT* p, float4 v, bool vec, int valid);

template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v, bool vec, int valid) {
    if (vec && valid == 4) {
        *reinterpret_cast<float4*>(p) = v;
    } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
        for (int i = 0; i < valid; ++i) p[i] = e[i];
    }
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, float4 v, bool vec, int valid) {
    if (vec && valid == 4) {
        __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
        uint2 u = {*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi)};
        *reinterpret_cast<uint2*>(p) = u;
    } else {
        const float e[4] = {v.x, v.y, v.z, v.w};
        for (int i = 0; i < valid; ++i) p[i] = __float2bfloat16_rn(e[i]);
    }
}

// A tile's k-splits form a cluster (1, 1, splits): block z of it sums k-blocks
// [z nk / splits, (z + 1) nk / splits); its rank in the cluster is z.
template <int BN, bool TRANS_A, typename OutT>
__global__ void __launch_bounds__(THREADS, Cfg<BN>::PER_SM)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                  OutT* __restrict__ C, int M, int N, int K, int ldc) {
    using Cf = Cfg<BN>;
    constexpr int BM = Cf::BM, MI = Cf::MI;
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full[Cf::STAGES], empty[Cf::STAGES];
    uint8_t* ring = align1024(smem_raw);

    const int tid = threadIdx.x, wg = tid / 128;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int splits = gridDim.z, split = blockIdx.z;
    const int nk = (K + BK - 1) / BK;
    const int kb0 = split * nk / splits, kb1 = (split + 1) * nk / splits;

    if (tid == 0) {
        for (int s = 0; s < Cf::STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], CONSUMERS);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (wg == CONSUMERS) {
        // producer: one thread keeps the ring full; the warpgroup leaves when it is done
        if constexpr (Cf::PRODUCER_REGS > 0) setmaxnreg_dec<Cf::PRODUCER_REGS>();
        if (tid == CONSUMERS * 128) {
            for (int kb = kb0, it = 0; kb < kb1; ++kb, ++it) {
                const int s = it % Cf::STAGES;
                mbar_wait(&empty[s], ((it / Cf::STAGES) & 1) ^ 1);  // the first round passes at once
                uint8_t* a_dst = ring + s * Cf::STAGE_BYTES;
                uint8_t* b_dst = a_dst + Cf::A_BYTES;
                mbar_arrive_expect_tx(&full[s], Cf::STAGE_BYTES);
                const int k0 = kb * BK;
                if (TRANS_A) {  // BM / 64 boxes of 64 (m) x 64 (k) of the stored (K, M) matrix
#pragma unroll
                    for (int c = 0; c < BM / 64; ++c) tma_load_2d(a_dst + c * CHUNK, &map_a, &full[s], m0 + 64 * c, k0);
                } else {  // one box of 64 (k) x BM (m) of the stored (M, K) matrix
                    tma_load_2d(a_dst, &map_a, &full[s], k0, m0);
                }
#pragma unroll
                for (int c = 0; c < BN / Cf::BW; ++c)
                    tma_load_2d(b_dst + c * Cf::B_BOX, &map_b, &full[s], n0 + Cf::BW * c, k0);
            }
        }
        return;  // the barriers below count the threads that have not exited
    }

    // consumers: warpgroup wg multiplies rows [64 MI wg, 64 MI (wg + 1)) of the tile; A's 64-row
    // tile c sits at c * CHUNK in both layouts
    if constexpr (Cf::CONSUMER_REGS > 0) setmaxnreg_inc<Cf::CONSUMER_REGS>();
    float acc[MI][BN / 2];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[i][j] = 0.f;
    for (int kb = kb0, it = 0; kb < kb1; ++kb, ++it) {
        const int s = it % Cf::STAGES;
        mbar_wait(&full[s], (it / Cf::STAGES) & 1);
        const uint32_t a_base = smem_u32(ring + s * Cf::STAGE_BYTES) + wg * MI * CHUNK;
        const uint32_t b_base = smem_u32(ring + s * Cf::STAGE_BYTES + Cf::A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t db = make_desc(b_base + kk * 16 * Cf::B_SW, Cf::B_BOX, 8 * Cf::B_SW, Cf::B_SW);
#pragma unroll
            for (int i = 0; i < MI; ++i) {
                const uint32_t a_tile = a_base + i * CHUNK;
                const uint64_t da = TRANS_A ? make_desc(a_tile + kk * 2048, CHUNK, 1024, 128)
                                            : make_desc(a_tile + kk * 32, 16, 1024, 128);
                WgmmaSS<BN, TRANS_A ? 1 : 0, 1>::mma(acc[i], da, db, 1);
            }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-block's products are done: release its stage
        if (it > 0 && tid % 128 == 0) mbar_arrive(&empty[(it - 1) % Cf::STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MI; ++i) fence_operands(acc[i]);

    // epilogue (consumers only): every load was consumed and every product is done, so the ring is free
    consumer_sync();
    float* Cs = reinterpret_cast<float*>(ring);
    const int lane = tid % 32;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
        const int r = (wg * MI + i) * 64 + (tid % 128) / 32 * 16 + lane / 4, c = 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            *reinterpret_cast<float2*>(&Cs[r * Cf::CLD + 8 * j + c]) = make_float2(acc[i][4 * j], acc[i][4 * j + 1]);
            *reinterpret_cast<float2*>(&Cs[(r + 8) * Cf::CLD + 8 * j + c]) =
                make_float2(acc[i][4 * j + 2], acc[i][4 * j + 3]);
        }
    }
    if (splits > 1)
        cluster_sync();  // every partial tile of the cluster is parked
    else
        consumer_sync();

    // this block sums rows [r0, r1) of the tile over the cluster's partials, in rank order
    const int rows = (BM + splits - 1) / splits, r0 = split * rows, r1 = min(BM, r0 + rows);
    const bool vec = (reinterpret_cast<uintptr_t>(C) % 16 == 0) && (ldc % 4 == 0);
    for (int idx = tid; idx < (r1 - r0) * (BN / 4); idx += CONSUMERS * 128) {
        const int r = r0 + idx / (BN / 4), c = (idx % (BN / 4)) * 4;
        const int gm = m0 + r, gn = n0 + c;
        if (gm >= M || gn >= N) continue;
        const float* local = &Cs[r * Cf::CLD + c];
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int z = 0; z < splits; ++z) {
            const float4 v = splits > 1 ? ld_cluster_f4(cluster_addr(smem_u32(local), z))
                                        : *reinterpret_cast<const float4*>(local);
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
        }
        store4<OutT>(C + (size_t)gm * ldc + gn, sum, vec, min(4, N - gn));
    }
    if (splits > 1) cluster_sync();  // no block leaves while another reads its shared memory
}

// Blocks in clusters of `size` that the card holds at once (cudaOccupancyMaxActiveClusters
// x size: a cluster must fit in one GPC, so large clusters leave SMs over), asked
// once per kernel and cluster size.
template <int BN, bool TRANS_A, typename OutT>
int resident_blocks(int size) {
    static std::atomic<int> cache[MAX_SPLITS + 1];  // 0: not asked yet
    int n = cache[size].load();
    if (n > 0) return n;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(size, 1, 1);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = Cfg<BN>::SMEM;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = size;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, gemm_wgmma_kernel<BN, TRANS_A, OutT>, &cfg) != cudaSuccess ||
        clusters <= 0) {
        cudaGetLastError();  // clear it: the launch reports a real fault
        return 0;
    }
    cache[size].store(clusters * size);
    return clusters * size;
}

template <int BN, bool TRANS_A, typename OutT>
int launch_wgmma(const void* a, const void* b, void* c, int M, int N, int K, int lda, int ldb, int ldc,
                 cudaStream_t stream) {
    using Cf = Cfg<BN>;
    auto kernel = gemm_wgmma_kernel<BN, TRANS_A, OutT>;
    cudaError_t e = repro::allow_smem(kernel, Cf::SMEM);
    if (e != cudaSuccess) return e;
    const int mt = (M + Cf::BM - 1) / Cf::BM, nt = (N + BN - 1) / BN, nk = (K + BK - 1) / BK;
    if (mt > 65535) return cudaErrorInvalidValue;
    // split K where the tiles alone leave SMs idle: the split (<= 4, >= 8 k-blocks each) with
    // the fewest waves x (k-blocks per block + 8), the 8 standing for a block's fixed cost
    // (filling the ring, the epilogue), waves counted over the blocks the card holds at once
    // in clusters of that size
    int splits = 1;
    long long best = -1;
    for (int s = 1; s <= MAX_SPLITS; ++s) {
        if (s > 1 && nk / s < 8) break;
        const int slots = resident_blocks<BN, TRANS_A, OutT>(s);
        if (slots <= 0) continue;
        const long long waves = ((long long)mt * nt * s + slots - 1) / slots;
        const long long cost = waves * ((nk + s - 1) / s + 8);
        if (best < 0 || cost < best) splits = s, best = cost;
    }

    CUtensorMap map_a, map_b;
    // A: the stored matrix, innermost dim first; (M, K) row-major, or (K, M) under TRANS_A
    const cuuint64_t a_dims[2] = {(cuuint64_t)(TRANS_A ? M : K), (cuuint64_t)(TRANS_A ? K : M)};
    const cuuint64_t a_strides[1] = {(cuuint64_t)lda * 2};
    const cuuint32_t a_box[2] = {64, TRANS_A ? 64u : (cuuint32_t)Cf::BM};
    if ((e = encode_bf16_map(&map_a, a, 2, a_dims, a_strides, a_box, 128)) != cudaSuccess) return e;
    const cuuint64_t b_dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t b_strides[1] = {(cuuint64_t)ldb * 2};
    const cuuint32_t b_box[2] = {(cuuint32_t)Cf::BW, BK};
    if ((e = encode_bf16_map(&map_b, b, 2, b_dims, b_strides, b_box, Cf::B_SW)) != cudaSuccess) return e;

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nt, mt, splits);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = Cf::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = splits;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, static_cast<OutT*>(c), M, N, K, ldc);
    return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename OutT>
int launch_bf16(const void* a, const void* b, void* c, int M, int N, int K, int lda, int ldb, int ldc, int trans_a,
                cudaStream_t stream) {
    if (M <= 0 || N <= 0) return cudaSuccess;
    if (K <= 0)  // an empty sum: C = 0 (zero bits in bf16 and fp32)
        return cudaMemset2DAsync(c, (size_t)ldc * sizeof(OutT), 0, (size_t)N * sizeof(OutT), M, stream);
    if (N <= 64)
        return trans_a ? launch_wgmma<64, true, OutT>(a, b, c, M, N, K, lda, ldb, ldc, stream)
                       : launch_wgmma<64, false, OutT>(a, b, c, M, N, K, lda, ldb, ldc, stream);
    return trans_a ? launch_wgmma<160, true, OutT>(a, b, c, M, N, K, lda, ldb, ldc, stream)
                   : launch_wgmma<160, false, OutT>(a, b, c, M, N, K, lda, ldb, ldc, stream);
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
