// The wgmma + TMA GEMM of the port's bf16 products: C[l] = op(A[l]) @ B[l]
// with an fp32 accumulator, over a stack of L independent products (L = 1
// for a plain GEMM).  Shared by sketch_matmul.cu (RSI's W @ Y and W^T @ X,
// the logits), lowrank_matmul.cu (both stages of (x @ A) @ B at M > 8) and
// lowrank_matmul_batched.cu (both stages over an expert stack).
//
//   A : the stored (M, K) row-major matrix with row stride lda, or under
//       TRANS_A the stored (K, M) matrix whose transpose is used (W^T is read
//       in place); stack stride sa.
//   B : (K, N) row-major with row stride ldb; stack stride sb.
//   C : (M, N) row-major with row stride ldc, in OutT (bf16, or fp32 to keep
//       the product unrounded); stack stride sc.
//
// * TMA loads A and B tiles into a ring of four shared-memory stages guarded
//   by mbarriers; one thread of a producer warpgroup keeps the ring full
//   (the warpgroup hands its registers to the consumers, setmaxnreg, where
//   a block has the SM to itself) while two consumer warpgroups issue wgmma
//   (bf16 in, fp32 accumulate in registers) on the tiles that have arrived,
//   one k-block's products in flight behind the next.  An expert stack's
//   tensor maps are 3-D (column, row, stack), so its matrices are read in
//   place through their row and stack strides; one matrix's are 2-D.
// * A is K-major, or under TRANS_A MN-major: the TMA boxes cover the stored
//   (K, M) matrix and the descriptor's transpose bit reads it as A^T.  B is
//   the stored (K, N) row-major matrix, MN-major with the transpose bit,
//   loaded as 32- or 64-column boxes (64- or 128-byte swizzle).
// * Tiles (Cfg<BM, BN>): 128 x 64 (two blocks an SM), 256 x 160 and
//   128 x 256 (one block an SM; a consumer warpgroup holds a 64 x 256 or two
//   64 x 160 accumulators).  The caller picks the tile and the k-split (its
//   plan); the bytes a tile pulls from L2 per flop, not the tensor cores,
//   set the pace at the port's shapes.
// * K is split over a cluster of `splits` blocks (<= 8) along gridDim.z
//   (blockIdx.z = l * splits + rank): rank z sums k-blocks
//   [z nk / splits, (z + 1) nk / splits).  After the main loop each block
//   parks its fp32 partial tile in its own shared memory and sums one row
//   slice of the tile over the cluster's partials through distributed
//   shared memory, always in rank order: the same bits on every launch, no
//   atomics and no second pass.
// * Liveness (the expert stacks): given `live`, a tile whose rows hold no
//   live 64-row granule (live[(l * granules + g) * parts + p] all zero for
//   its granules) loads nothing and writes zeros to its rows of C.  The
//   caller guarantees that a dead granule's rows of A are zero and the
//   factors finite, so the zeros are the product's own bits; a live row's
//   bits do not depend on which other tiles are live (the K order of every
//   sum is fixed by the plan).
// * The epilogue goes through shared memory (the ring, free by then) and
//   writes C with 16-byte (fp32) or 8-byte (bf16) stores, cut at the ragged
//   M and N edges; TMA zero-fills the ragged edges of the loads.
// * TMA needs 16-byte aligned bases, row strides and stack strides: the
//   Python wrappers copy any other operand into aligned rows first (and
//   count it, _build.ALIGN_COPIES).  Tensor maps are encoded on the host
//   per call and passed as __grid_constant__ parameters, so a captured CUDA
//   graph replays them over its fixed buffers.
#pragma once

#include <atomic>

#include "hopper.cuh"

namespace repro {
namespace wg {

using namespace hopper;

constexpr int BK = 64;                          // k-block: one 128-byte swizzle row of bf16
constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + a producer warpgroup (one thread of it issues the loads)
constexpr int MAX_SPLITS = 8;                   // k-splits of a tile: the blocks of a (portable) cluster
constexpr int CHUNK = 64 * BK * 2;              // one 64-row (or 64-column) TMA box of a k-block of A: 8 KB
constexpr int GRANULE = 64;                     // rows one liveness flag covers
constexpr int SM_SMEM = 233472;                 // shared memory of one SM (1 KB of it reserved a resident block)

// A block's tile is BM x BN: each consumer warpgroup owns MI row tiles of 64
// (MI wgmma accumulators of 64 x BN).  B's tile is BN / BW boxes of BW
// columns, swizzled by BW * 2 bytes.  kernels/lowrank_matmul.py mirrors
// SMEM and PER_SM (tile_smem, tile_per_sm).
template <int BM_, int BN_>
struct Cfg {
    static constexpr int BM = BM_, BN = BN_;
    static constexpr int MI = BM / (CONSUMERS * 64);  // 1 or 2
    static constexpr int BW = BN % 64 == 0 ? 64 : 32;
    static constexpr int B_SW = BW * 2;              // 128 or 64 bytes
    static constexpr int B_BOX = BK * BW * 2;        // bytes of one B box
    static constexpr int STAGES = 4;
    static constexpr int A_BYTES = BM * BK * 2;
    static constexpr int B_BYTES = BK * BN * 2;
    static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
    static constexpr int CLD = BN + 4;                        // row stride of the fp32 epilogue tile
    static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring to 1024 bytes
    static constexpr int PER_SM = 2 * (SMEM + 1024) <= SM_SMEM ? 2 : 1;  // blocks an SM holds (shared memory)
    // registers a thread after the producer warpgroup hands its registers to the consumers
    // (one block an SM: 384 threads start at 168; 128 x 40 + 256 x 232 <= 65536), 0: no hand-over
    static constexpr int PRODUCER_REGS = PER_SM == 1 ? 40 : 0;
    static constexpr int CONSUMER_REGS = PER_SM == 1 ? 232 : 0;
    static_assert(MI >= 1 && BM == CONSUMERS * 64 * MI, "64-row tiles per consumer warpgroup");
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

// The block's work under grid (N tiles, M tiles, L x splits), clusters (1, 1, splits).  STACK:
// 3-D tensor maps (column, row, stack) and liveness flags; else 2-D maps of one matrix.
template <class Cf, bool TRANS_A, typename OutT, bool STACK>
__device__ __forceinline__ void gemm_body(const CUtensorMap& map_a, const CUtensorMap& map_b, OutT* __restrict__ C,
                                          int M, int N, int K, int ldc, long long sc, int splits,
                                          const uint8_t* __restrict__ live, int parts) {
    constexpr int BM = Cf::BM, BN = Cf::BN, MI = Cf::MI;
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full[Cf::STAGES], empty[Cf::STAGES];
    uint8_t* ring = align1024(smem_raw);

    const int tid = threadIdx.x, wg = tid / 128;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    // a stack's blockIdx.z is l x splits + split; one matrix's is its split (splits = gridDim.z)
    if constexpr (!STACK) splits = gridDim.z;
    const int l = STACK ? blockIdx.z / splits : 0, split = STACK ? blockIdx.z % splits : blockIdx.z;
    const int nk = (K + BK - 1) / BK;
    const int kb0 = split * nk / splits, kb1 = (split + 1) * nk / splits;

    if (STACK && live != nullptr) {
        // a tile whose granules are all dead: zeros, nothing loaded (every block of the cluster agrees)
        const int granules = (M + GRANULE - 1) / GRANULE;
        const int g1 = min(granules, (m0 + BM + GRANULE - 1) / GRANULE);
        const uint8_t* f = live + ((size_t)l * granules + m0 / GRANULE) * parts;
        int any = 0;
        for (int i = 0; i < (g1 - m0 / GRANULE) * parts; ++i) any |= f[i];
        if (!any) {
            // this block's slice of the tile's rows, as in the epilogue
            const int rows = (BM + splits - 1) / splits, r0 = split * rows, r1 = min(BM, r0 + rows);
            const bool vec = (reinterpret_cast<uintptr_t>(C) % 16 == 0) && (ldc % 4 == 0) && (sc % 4 == 0);
            C += l * sc;
            for (int idx = tid; idx < (r1 - r0) * (BN / 4); idx += THREADS) {
                const int r = r0 + idx / (BN / 4), c = (idx % (BN / 4)) * 4;
                const int gm = m0 + r, gn = n0 + c;
                if (gm < M && gn < N)
                    store4<OutT>(C + (size_t)gm * ldc + gn, make_float4(0.f, 0.f, 0.f, 0.f), vec, min(4, N - gn));
            }
            return;
        }
    }

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
                auto load = [&](void* dst, const CUtensorMap* map, int c0, int c1) {
                    if constexpr (STACK)
                        tma_load_3d(dst, map, &full[s], c0, c1, l);
                    else
                        tma_load_2d(dst, map, &full[s], c0, c1);
                };
                if (TRANS_A) {  // BM / 64 boxes of 64 (m) x 64 (k) of the stored (K, M) matrix
#pragma unroll
                    for (int c = 0; c < BM / 64; ++c) load(a_dst + c * CHUNK, &map_a, m0 + 64 * c, k0);
                } else {  // one box of 64 (k) x BM (m) of the stored (M, K) matrix
                    load(a_dst, &map_a, k0, m0);
                }
#pragma unroll
                for (int c = 0; c < BN / Cf::BW; ++c) load(b_dst + c * Cf::B_BOX, &map_b, n0 + Cf::BW * c, k0);
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
    const bool vec = (reinterpret_cast<uintptr_t>(C) % 16 == 0) && (ldc % 4 == 0) && (sc % 4 == 0);
    C += l * sc;
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

// Two kernels over one body, so a profile tells them apart: gemm_kernel (one matrix: 2-D
// tensor maps, no liveness flags) and expert_gemm_kernel (the expert stacks: 3-D maps, flags).
template <class Cf, bool TRANS_A, typename OutT>
__global__ void __launch_bounds__(THREADS, Cf::PER_SM)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            OutT* __restrict__ C, int M, int N, int K, int ldc, long long sc, int splits,
            const uint8_t* __restrict__ live, int parts) {
    gemm_body<Cf, TRANS_A, OutT, false>(map_a, map_b, C, M, N, K, ldc, sc, splits, nullptr, 0);
}

template <class Cf, bool TRANS_A, typename OutT>
__global__ void __launch_bounds__(THREADS, Cf::PER_SM)
expert_gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                   OutT* __restrict__ C, int M, int N, int K, int ldc, long long sc, int splits,
                   const uint8_t* __restrict__ live, int parts) {
    gemm_body<Cf, TRANS_A, OutT, true>(map_a, map_b, C, M, N, K, ldc, sc, splits, live, parts);
}

template <class Cf, bool TRANS_A, typename OutT, bool EXPERTS>
constexpr auto kernel_of() {
    if constexpr (EXPERTS)
        return expert_gemm_kernel<Cf, TRANS_A, OutT>;
    else
        return gemm_kernel<Cf, TRANS_A, OutT>;
}

// Blocks in clusters of `size` that the card holds at once (cudaOccupancyMaxActiveClusters
// x size: a cluster must fit in one GPC, so large clusters leave SMs over), asked
// once per kernel and cluster size; 0 if the card cannot say.
template <class Cf, bool TRANS_A, typename OutT>
int resident_blocks(int size) {
    static std::atomic<int> cache[MAX_SPLITS + 1];  // 0: not asked yet
    int n = cache[size].load();
    if (n > 0) return n;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(size, 1, 1);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = Cf::SMEM;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = size;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (allow_smem(gemm_kernel<Cf, TRANS_A, OutT>, Cf::SMEM) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&clusters, gemm_kernel<Cf, TRANS_A, OutT>, &cfg) != cudaSuccess ||
        clusters <= 0) {
        cudaGetLastError();  // clear it: the launch reports a real fault
        return 0;
    }
    cache[size].store(clusters * size);
    return clusters * size;
}

// One launch of C[l] = op(A[l]) @ B[l], l < L, on tile Cf with K split over `splits` blocks.
// Strides in elements; a stack of one ignores them.  EXPERTS: expert_gemm_kernel, reading
// `live`, the liveness flags [L][ceil(M / 64)][parts] of A's row granules.
template <class Cf, bool TRANS_A, typename OutT, bool EXPERTS = false>
cudaError_t launch(const void* a, const void* b, void* c, int M, int N, int K, int lda, int ldb, int ldc, int L,
                   long long sa, long long sb, long long sc, int splits, const uint8_t* live, int parts,
                   cudaStream_t stream) {
    auto kernel = kernel_of<Cf, TRANS_A, OutT, EXPERTS>();
    cudaError_t e = allow_smem(kernel, Cf::SMEM);
    if (e != cudaSuccess) return e;
    const long long mt = (M + Cf::BM - 1) / Cf::BM, nt = (N + Cf::BN - 1) / Cf::BN;
    if (splits < 1 || splits > MAX_SPLITS || mt > 65535 || (long long)L * splits > 65535 || nt > 0x7fffffff ||
        (!EXPERTS && L != 1))
        return cudaErrorInvalidValue;
    const int a_rows = TRANS_A ? K : M, a_cols = TRANS_A ? M : K;
    if (L == 1) sa = (long long)a_rows * lda, sb = (long long)K * ldb;  // any 16-byte multiple will do

    CUtensorMap map_a, map_b;
    const int rank = EXPERTS ? 3 : 2;  // the stack's dim last (expert_gemm_kernel's 3-D loads)
    // A: the stored matrix, innermost dim first; (M, K) row-major, or (K, M) under TRANS_A
    const cuuint64_t a_dims[3] = {(cuuint64_t)a_cols, (cuuint64_t)a_rows, (cuuint64_t)L};
    const cuuint64_t a_strides[2] = {(cuuint64_t)lda * 2, (cuuint64_t)sa * 2};
    const cuuint32_t a_box[3] = {64, TRANS_A ? 64u : (cuuint32_t)Cf::BM, 1};
    if ((e = encode_bf16_map(&map_a, a, rank, a_dims, a_strides, a_box, 128)) != cudaSuccess) return e;
    const cuuint64_t b_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)L};
    const cuuint64_t b_strides[2] = {(cuuint64_t)ldb * 2, (cuuint64_t)sb * 2};
    const cuuint32_t b_box[3] = {(cuuint32_t)Cf::BW, BK, 1};
    if ((e = encode_bf16_map(&map_b, b, rank, b_dims, b_strides, b_box, Cf::B_SW)) != cudaSuccess) return e;

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)nt, (unsigned)mt, (unsigned)(L * splits));
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
    e = cudaLaunchKernelEx(&cfg, kernel, map_a, map_b, static_cast<OutT*>(c), M, N, K, ldc, sc, splits, live, parts);
    return e != cudaSuccess ? e : cudaGetLastError();
}

// launch() on the tile (bm, bn) of a plan: 128 x 64, 256 x 160 or 128 x 256.
template <bool TRANS_A, typename OutT, bool EXPERTS = false>
cudaError_t launch_tile(int bm, int bn, const void* a, const void* b, void* c, int M, int N, int K, int lda, int ldb,
                        int ldc, int L, long long sa, long long sb, long long sc, int splits, const uint8_t* live,
                        int parts, cudaStream_t stream) {
    if (bm == 128 && bn == 64)
        return launch<Cfg<128, 64>, TRANS_A, OutT, EXPERTS>(a, b, c, M, N, K, lda, ldb, ldc, L, sa, sb, sc, splits, live,
                                                   parts, stream);
    if (bm == 256 && bn == 160)
        return launch<Cfg<256, 160>, TRANS_A, OutT, EXPERTS>(a, b, c, M, N, K, lda, ldb, ldc, L, sa, sb, sc, splits, live,
                                                    parts, stream);
    if (bm == 128 && bn == 256)
        return launch<Cfg<128, 256>, TRANS_A, OutT, EXPERTS>(a, b, c, M, N, K, lda, ldb, ldc, L, sa, sb, sc, splits, live,
                                                    parts, stream);
    return cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace repro
