// lowrank_matmul: y = (x @ A) @ B, the serving hot path of a compressed linear.
//
// Replaces the TPU kernel repro/kernels/lowrank_matmul.py::lowrank_matmul_pallas
// (kernel lowrank_matmul_kernel, pallas_call at :174), with its numerics:
// t = x @ A accumulates in fp32 and is rounded to x's dtype, then y = t @ B
// accumulates in fp32 and is written in x's dtype.
//
// What bounds it on the H100: at decode (M = batch <= 8) the work is the
// bytes of the two factors — w_gate at alpha 0.3 is A 2048x615 plus
// B 615x8192 in bf16, 12.6 MB, about 3.8 us at 3.35 TB/s — and at prefill
// (M = 256 a chunk, 1024 the static batch) it is a GEMM pair of 3-13 GFLOP.
// The TPU kernel kept t in VMEM and all of B resident there; B does not fit
// in a Hopper SM's 227 KB, and a block that recomputed t for each N tile
// would re-read all of A once per tile.  So the two stages are two launches
// on one stream, t (M x r: 10 KB at decode, 1.3 MB at prefill) going
// through a scratch buffer that stays in the 50 MB L2, each factor read once
// per call.  Each stage is one launch under the wrapper's plan
// (kernels/lowrank_matmul.py::lowrank_plans, a function of the shapes and
// the SM count alone):
// * M <= 8 (decode), bf16: the skinny kernel below.  A block owns BN
//   (32, 64 or 128) columns of the factor W and a run of K's 64-row blocks;
//   the K runs of one column tile are the blocks of a thread-block cluster
//   (<= 8), so every block of a call is resident in one wave.  A producer
//   warp streams the block's rows of W through a ring of TMA stages (up to
//   64 KB in flight a block, 128-byte swizzled boxes of 64 columns, or
//   64-byte ones of 32); four consumer warps each take one 16-row k step of
//   every stage on the tensor cores: mma.sync m16n8k16 with the W tile as the
//   16-row operand (ldmatrix.trans of the [k][n] tile: rows n, columns k)
//   and x^T as the n8 operand (x's rows, zero past M, from the block's chunk
//   of x in shared memory), so M <= 8 wastes no multiply and no weight is
//   converted on the FMA units.  The four warps' partials are summed in warp
//   order in shared memory, then the cluster's block partials in rank order
//   through distributed shared memory (hopper.cuh), and the block writes its
//   slice of the output rounded to bf16: no fp32 workspace, no reduce pass,
//   and the same bits on every launch.  Each launch is a programmatic
//   dependent launch (hopper.cuh): a stage starts, and streams its weights,
//   while the kernel before it finishes (stage 2 while stage 1 does, since
//   its factor does not depend on t), and waits for that kernel only before
//   it reads its activations.
// * M <= 8, fp32: the same kernel with FMA products in place of mma.sync
//   (tensor cores would take fp32 through TF32, which breaks the 1e-4 fp32
//   tolerance): each lane owns a column of the stage's 32-column boxes.
// * M > 8 (prefill), bf16: the wgmma + TMA GEMM of gemm_wgmma.cuh on the
//   plan's tile (128 x 64, 256 x 160 or 128 x 256) and k-split; fp32:
//   gemm_tile.cuh's FMA tiles.
// Any rank is accepted (r is masked, N is tiled), including the break-even
// cap of 1638 for 2048x8192.  TMA reads the factors (and x and t at M > 8)
// in place: the wrapper copies an operand whose base or row stride is not
// on 16 bytes into aligned rows first, and counts it.
#include <type_traits>

#include "gemm_tile.cuh"
#include "gemm_wgmma.cuh"

namespace {

using namespace repro::hopper;
using bf16 = __nv_bfloat16;

constexpr int SK_MAX_M = 8;                    // rows of x the skinny kernel takes (the mma's n8)
constexpr int SK_BK = 64;                      // rows of W a ring stage: one 16-row k step a consumer warp
constexpr int SK_WARPS = 4;                    // consumer warps
constexpr int SK_THREADS = (SK_WARPS + 1) * 32;  // + a producer warp (one lane issues the loads)
constexpr int SK_RING = 65536;                 // bytes of W in flight a block (at most)
constexpr int SK_MAX_STAGES = SK_RING / (SK_BK * 32 * 2);
constexpr int SK_MAX_SPLITS = 8;               // the blocks of a portable cluster
constexpr size_t SMEM_MAX = 232448;

// Dynamic shared memory of a skinny block whose K run is at most nk k-blocks, for elements of
// esz bytes: the ring, x's chunk [8][nk * 64 + 8], the block's partial [8][BN] fp32, and 1 KB to
// align the ring.  kernels/lowrank_matmul.py::skinny_smem mirrors it.
inline int sk_stages(int bn, int nk, int esz) {
    const int fit = SK_RING / (SK_BK * bn * esz);
    return nk < fit ? nk : fit;
}
inline size_t sk_smem(int bn, int nk, int esz) {
    return 1024 + (size_t)sk_stages(bn, nk, esz) * SK_BK * bn * esz + (size_t)SK_MAX_M * (nk * SK_BK + 8) * esz +
           (size_t)SK_MAX_M * bn * 4;
}

// Columns of one TMA box of W: a 128-byte swizzle row (bf16 64, fp32 32), or bf16 BN = 32 in
// one 64-byte row.
template <typename T, int BN>
__host__ __device__ constexpr int sk_box_cols() {
    return sizeof(T) == 2 ? (BN < 64 ? BN : 64) : 32;
}

__device__ __forceinline__ void sk_consumer_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(SK_WARPS * 32) : "memory");
}

// A consumer warp's products over its 16-row k step of each stage, bf16 on the tensor cores.
// Fragments (PTX ISA, mma m16n8k16; lane = 4 gid + tig).  A = W^T (rows n, columns k):
// ldmatrix.x4.trans of the stored [k][n] tile, matrices (n 0-7 | 8-15) x (k 0-7 | 8-15), lane
// l giving row k = (l & 7) + 8 ((l >> 4) & 1) at column n = 8 ((l >> 3) & 1).  B = x^T
// (rows k, columns m): b0 = x[gid][k + 2 tig, +1], b1 = x[gid][k + 8 + 2 tig, +1].
// C = y^T: c[e] is y[m = 2 tig + (e & 1)][n = gid + 8 (e >> 1)].
template <int BN>
struct SkinnyMma {
    static constexpr int BW = sk_box_cols<bf16, BN>(), SW = BW * 2, BOX = SK_BK * SW;
    float acc[BN / 16][4];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int j = 0; j < BN / 16; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }

    // the stage's tile, x's chunk xs (row stride XS) from the stage's first column kx0
    __device__ __forceinline__ void step(const uint8_t* stage, const bf16* xs, int XS, int kx0, int warp, int lane) {
        const uint32_t base = smem_u32(stage);
        const int gid = lane >> 2, tig = lane & 3;
        const int krow = warp * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
        const int ncol = ((lane >> 3) & 1) * 8;
        const bf16* xrow = xs + gid * XS + kx0 + warp * 16 + 2 * tig;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xrow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xrow + 8);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
            const int n = 16 * j + ncol;
            uint32_t a[4];
            ldmatrix_x4_trans(a, base + (n / BW) * BOX + swizzle<SW>(krow * SW + (n % BW) * 2));
            mma_16816(acc[j], a, b0, b1);
        }
    }

    // this warp's partial into red[m][BN]
    __device__ __forceinline__ void park(float* red, int lane) const {
        const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
        for (int j = 0; j < BN / 16; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) red[(2 * tig + (e & 1)) * BN + 16 * j + gid + 8 * (e >> 1)] = acc[j][e];
    }
};

// The same in fp32 on the FMA units (tensor cores would take fp32 through TF32, which breaks
// the 1e-4 fp32 tolerance): lane l owns column 32 b + l of each 32-column box b, and walks the
// warp's 16 rows of the stage in order, x's 8 values of a row broadcast from shared memory.
template <int BN>
struct SkinnyFma {
    static constexpr int BOX = SK_BK * 128;
    float acc[BN / 32][SK_MAX_M];

    __device__ __forceinline__ void init() {
#pragma unroll
        for (int b = 0; b < BN / 32; ++b)
#pragma unroll
            for (int m = 0; m < SK_MAX_M; ++m) acc[b][m] = 0.f;
    }

    __device__ __forceinline__ void step(const uint8_t* stage, const float* xs, int XS, int kx0, int warp, int lane) {
#pragma unroll 4
        for (int kk = 0; kk < 16; ++kk) {
            const int k = warp * 16 + kk;
            float xv[SK_MAX_M];
#pragma unroll
            for (int m = 0; m < SK_MAX_M; ++m) xv[m] = xs[m * XS + kx0 + k];
#pragma unroll
            for (int b = 0; b < BN / 32; ++b) {
                const float w = *reinterpret_cast<const float*>(stage + b * BOX + swizzle<128>(k * 128 + lane * 4));
#pragma unroll
                for (int m = 0; m < SK_MAX_M; ++m) acc[b][m] = fmaf(xv[m], w, acc[b][m]);
            }
        }
    }

    __device__ __forceinline__ void park(float* red, int lane) const {
#pragma unroll
        for (int b = 0; b < BN / 32; ++b)
#pragma unroll
            for (int m = 0; m < SK_MAX_M; ++m) red[m * BN + 32 * b + lane] = acc[b][m];
    }
};

// Grid (splits, N tiles), clusters (splits, 1, 1): block z of a column tile sums W's k-blocks
// [z nkb / splits, (z + 1) nkb / splits).  Its rank in the cluster is z.
template <typename T, int BN>
__global__ void __launch_bounds__(SK_THREADS)
skinny_kernel(const __grid_constant__ CUtensorMap map_w, const T* __restrict__ x, T* __restrict__ y, int M, int N,
              int K, int ldx, int ldy, int stages, int kc_max, bool x_vec) {
    using Warp = typename std::conditional<sizeof(T) == 2, SkinnyMma<BN>, SkinnyFma<BN>>::type;
    constexpr int BW = sk_box_cols<T, BN>();
    constexpr int BOX = SK_BK * BW * (int)sizeof(T);  // bytes of a box (1024-byte multiple: the swizzle's atom)
    constexpr int STAGE = SK_BK * BN * (int)sizeof(T);
    constexpr int VEC = 16 / sizeof(T);
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t full[SK_MAX_STAGES], empty[SK_MAX_STAGES];
    uint8_t* ring = align1024(smem_raw);
    const int XS = kc_max + 8;  // row stride of x's chunk: bf16 rows 4 banks apart for the fragment loads
    T* xs = reinterpret_cast<T*>(ring + (size_t)stages * STAGE);
    float* part = reinterpret_cast<float*>(xs + SK_MAX_M * XS);  // [SK_MAX_M][BN]

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int splits = gridDim.x, rank = blockIdx.x, n0 = blockIdx.y * BN;
    const int nkb = (K + SK_BK - 1) / SK_BK;
    const int kb0 = rank * nkb / splits, nk = (rank + 1) * nkb / splits - kb0;
    const int k0 = kb0 * SK_BK, kc = nk * SK_BK;

    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], SK_WARPS);
        }
        fence_barrier_init();
    }
    __syncthreads();
    // the next kernel on the stream (the other stage, the next call's first) may start its
    // prologue and its weight loads now; it waits for this grid before touching activations
    launch_dependents();

    if (warp == SK_WARPS) {
        // producer: one lane keeps the ring full (the weights: no wait for the kernel before);
        // the warp leaves when it is done
        if (lane == 0) {
            for (int it = 0; it < nk; ++it) {
                const int s = it % stages;
                mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);  // the first round passes at once
                mbar_arrive_expect_tx(&full[s], STAGE);
                uint8_t* dst = ring + (size_t)s * STAGE;
#pragma unroll
                for (int b = 0; b < BN / BW; ++b)
                    tma_load_2d(dst + b * BOX, &map_w, &full[s], n0 + b * BW, k0 + it * SK_BK);
            }
        }
        return;  // the barriers below count the threads that have not exited
    }

    // x's chunk while the ring fills, once the kernel that wrote x (stage 1's t) is done and no
    // earlier kernel still reads what this grid writes: rows < M, columns [k0, k0 + kc) of K,
    // zeros past either
    grid_dependency_wait();
    for (int i = tid; i < SK_MAX_M * (kc / VEC); i += SK_WARPS * 32) {
        const int m = i / (kc / VEC), c = (i % (kc / VEC)) * VEC;
        *reinterpret_cast<uint4*>(xs + m * XS + c) = repro::load_chunk<T>(x, ldx, M, K, m, k0 + c, x_vec);
    }
    sk_consumer_sync();

    Warp w;
    w.init();
    for (int it = 0; it < nk; ++it) {
        const int s = it % stages;
        mbar_wait(&full[s], (it / stages) & 1);
        w.step(ring + (size_t)s * STAGE, xs, XS, it * SK_BK, warp, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    }

    // the warps' partials in the ring (every load has landed and been read), summed in warp order
    sk_consumer_sync();
    float* red = reinterpret_cast<float*>(ring);  // [SK_WARPS][SK_MAX_M][BN]: within one stage's bytes
    w.park(red + warp * SK_MAX_M * BN, lane);
    sk_consumer_sync();
    for (int i = tid; i < SK_MAX_M * BN; i += SK_WARPS * 32) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < SK_WARPS; ++w) v += red[w * SK_MAX_M * BN + i];
        part[i] = v;
    }
    if (splits > 1)
        cluster_sync();  // every block partial of the cluster is in place
    else
        sk_consumer_sync();

    // this block's slice of the M x BN outputs: the cluster's partials in rank order, rounded once
    const int total = M * BN, per = (total + splits - 1) / splits, lo = rank * per, hi = min(total, lo + per);
    for (int i = lo + tid; i < hi; i += SK_WARPS * 32) {
        const int m = i / BN, n = n0 + i % BN;
        float v = 0.f;
        if (splits > 1) {
            const uint32_t addr = smem_u32(part + i);
            for (int z = 0; z < splits; ++z) v += ld_cluster_f32(cluster_addr(addr, z));
        } else {
            v = part[i];
        }
        if (n < N) y[(size_t)m * ldy + n] = repro::from_f32<T>(v);
    }
    if (splits > 1) cluster_sync();  // no block leaves while another reads its shared memory
}

template <typename T, int BN>
cudaError_t launch_skinny(const void* x, const void* w, void* y, int M, int N, int K, int ldx, int ldw, int ldy,
                          int splits, cudaStream_t stream) {
    constexpr int BW = sk_box_cols<T, BN>(), ESZ = sizeof(T);
    const int nkb = (K + SK_BK - 1) / SK_BK;
    const long long tiles = (N + BN - 1) / BN;
    if (M > SK_MAX_M || splits < 1 || splits > SK_MAX_SPLITS || splits > nkb || tiles > 65535)
        return cudaErrorInvalidValue;
    const int nk_max = (nkb + splits - 1) / splits;
    const size_t smem = sk_smem(BN, nk_max, ESZ);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    auto kernel = skinny_kernel<T, BN>;
    cudaError_t e = repro::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    CUtensorMap map;
    const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
    const cuuint64_t strides[1] = {(cuuint64_t)ldw * ESZ};
    const cuuint32_t box[2] = {(cuuint32_t)BW, SK_BK};
    const CUtensorMapDataType type = ESZ == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    if ((e = encode_map(&map, type, w, 2, dims, strides, box, BW * ESZ)) != cudaSuccess) return e;

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, (unsigned)tiles, 1);
    cfg.blockDim = dim3(SK_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;  // programmatic dependent launch
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
    e = cudaLaunchKernelEx(&cfg, kernel, map, static_cast<const T*>(x), static_cast<T*>(y), M, N, K, ldx, ldy,
                           sk_stages(BN, nk_max, ESZ), nk_max * SK_BK, repro::vec_ok(x, ldx, ESZ));
    return e != cudaSuccess ? e : cudaGetLastError();
}

// One stage, c = a @ w (M x K @ K x N), under its plan: bm 0 the skinny kernel on bn columns a
// block with `splits` blocks a cluster over K; else bf16 the wgmma tile bm x bn (`splits` over
// K), fp32 gemm_tile.cuh's FMA tiles.
template <typename T>
cudaError_t stage(const void* a, const void* w, void* c, int M, int N, int K, int lda, int ldw, int ldc, int bm, int bn,
                  int splits, cudaStream_t s) {
    if (M <= 0 || N <= 0) return cudaSuccess;
    if (K <= 0)  // an empty sum: zeros
        return cudaMemset2DAsync(c, (size_t)ldc * sizeof(T), 0, (size_t)N * sizeof(T), M, s);
    if (bm == 0) {
        if (bn == 32) return launch_skinny<T, 32>(a, w, c, M, N, K, lda, ldw, ldc, splits, s);
        if (bn == 64) return launch_skinny<T, 64>(a, w, c, M, N, K, lda, ldw, ldc, splits, s);
        if (bn == 128) return launch_skinny<T, 128>(a, w, c, M, N, K, lda, ldw, ldc, splits, s);
        return cudaErrorInvalidValue;
    }
    if constexpr (sizeof(T) == 4)
        return repro::launch_gemm_f32(a, w, c, M, N, K, lda, ldw, ldc, false, s);
    else
        return repro::wg::launch_tile<false, bf16>(bm, bn, a, w, c, M, N, K, lda, ldw, ldc, 1, 0, 0, 0, splits,
                                                   nullptr, 0, s);
}

template <typename T>
int lowrank(const void* x, const void* A, const void* B, void* t, void* y, int M, int K, int r, int N, int ldx,
            int lda, int ldt, int ldb, int ldy, int bm1, int bn1, int s1, int bm2, int bn2, int s2, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t e = stage<T>(x, A, t, M, r, K, ldx, lda, ldt, bm1, bn1, s1, s);
    if (e != cudaSuccess) return e;
    return stage<T>(t, B, y, M, N, r, ldt, ldb, ldy, bm2, bn2, s2, s);
}

}  // namespace

// The factors (and, bf16 at M > 8, x and t) with 16-byte aligned bases and row strides (the
// wrapper ensures it); (bm1, bn1, s1) and (bm2, bn2, s2) the two stages' plans
REPRO_EXPORT int lowrank_matmul_bf16(const void* x, const void* A, const void* B, void* t, void* y, int M, int K,
                                     int r, int N, int ldx, int lda, int ldt, int ldb, int ldy, int bm1, int bn1,
                                     int s1, int bm2, int bn2, int s2, void* stream) {
    return lowrank<bf16>(x, A, B, t, y, M, K, r, N, ldx, lda, ldt, ldb, ldy, bm1, bn1, s1, bm2, bn2, s2, stream);
}

REPRO_EXPORT int lowrank_matmul_f32(const void* x, const void* A, const void* B, void* t, void* y, int M, int K, int r,
                                    int N, int ldx, int lda, int ldt, int ldb, int ldy, int bm1, int bn1, int s1,
                                    int bm2, int bn2, int s2, void* stream) {
    return lowrank<float>(x, A, B, t, y, M, K, r, N, ldx, lda, ldt, ldb, ldy, bm1, bn1, s1, bm2, bn2, s2, stream);
}
