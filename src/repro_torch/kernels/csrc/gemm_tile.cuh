// Tiled GEMM with an fp32 accumulator: C = op(A) @ B.
//
// Shared by sketch_matmul.cu (RSI's W @ Y and W^T @ X, the tied-embedding
// logits) and lowrank_matmul.cu (both stages of (x @ A) @ B).
//
//   A : (M, K) row-major with row stride lda, or under TRANS_A the stored
//       (K, M) matrix whose transpose is used — W^T is read in place, never
//       materialized.
//   B : (K, N) row-major with row stride ldb.
//   C : (M, N) row-major with row stride ldc, in OutT (the input type, or
//       fp32 to keep the product unrounded).
//
// One 128-thread block per 64x64 output tile; the K loop walks 32-deep
// slabs through shared memory.  The next slab's global loads are issued
// into registers before the current slab's products, so their latency
// overlaps the math.  Loads are 16-byte vectors when the operand's row
// stride and base allow it (the wrappers pad row strides to a multiple of
// 8 elements where they allocate), and element loads otherwise; ragged
// edges are zero-filled, so any M, N, K is accepted.
//
// Batched: blockIdx.z indexes a stack of independent products (A, B and C
// each offset by its own stack stride sa / sb / sc, in elements), so one
// launch covers a whole (L, M, K) @ (L, K, N) stack; a plain GEMM is the
// stack of one (gridDim.z = 1, strides unused).
//
// bf16 runs on the tensor cores through WMMA 16x16x16 fragments (four
// warps, 32x32 each); fp32 runs on the FMA units (each thread 8x4 outputs),
// which keeps fp32 products in full fp32 (no TF32).
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace repro {

constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 32;
constexpr int GEMM_THREADS = 128;

// Load 16 bytes (VEC elements) of row r starting at column c of a
// (rows x cols) row-major matrix with row stride ld; out-of-range elements
// read as zero.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ base, int ld, int rows, int cols,
                                            int r, int c, bool vec_ok) {
    constexpr int VEC = 16 / sizeof(T);
    uint4 out;
    if (vec_ok && r < rows && c + VEC <= cols) {
        out = __ldg(reinterpret_cast<const uint4*>(base + (size_t)r * ld + c));
    } else {
        __align__(16) T tmp[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i)
            tmp[i] = (r < rows && c + i < cols) ? base[(size_t)r * ld + c + i] : from_f32<T>(0.f);
        out = *reinterpret_cast<const uint4*>(tmp);
    }
    return out;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through WMMA.
// ---------------------------------------------------------------------------
template <bool TRANS_A, typename OutT>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                 OutT* __restrict__ C, int M, int N, int K, int lda, int ldb, int ldc,
                 long long sa, long long sb, long long sc, bool a_vec, bool b_vec) {
    using namespace nvcuda;
    using T = __nv_bfloat16;
    constexpr int VEC = 8;
    // A tile: [m][k] (row_major fragments) or, under TRANS_A, [k][m] (col_major).
    constexpr int A_ROWS = TRANS_A ? GEMM_BK : GEMM_BM;
    constexpr int A_COLS = TRANS_A ? GEMM_BM : GEMM_BK;
    constexpr int A_LD = A_COLS + 8;
    constexpr int B_LD = GEMM_BN + 8;
    constexpr int C_LD = GEMM_BN + 4;
    constexpr int A_CHUNKS = A_ROWS * A_COLS / VEC / GEMM_THREADS;  // 2
    constexpr int B_CHUNKS = GEMM_BK * GEMM_BN / VEC / GEMM_THREADS;  // 2
    __shared__ __align__(128) T As[A_ROWS * A_LD];
    __shared__ __align__(128) T Bs[GEMM_BK * B_LD];
    __shared__ __align__(128) float Cs[GEMM_BM * C_LD];

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int wm = warp / 2, wn = warp % 2;
    const int m0 = blockIdx.y * GEMM_BM;
    const int n0 = blockIdx.x * GEMM_BN;
    A += blockIdx.z * sa;
    B += blockIdx.z * sb;
    C += blockIdx.z * sc;

    // stored-matrix extents of A (rows x cols as laid out in memory)
    const int a_rows = TRANS_A ? K : M;
    const int a_cols = TRANS_A ? M : K;

    uint4 ra[A_CHUNKS], rb[B_CHUNKS];
    auto load_tiles = [&](int k0) {
#pragma unroll
        for (int i = 0; i < A_CHUNKS; ++i) {
            int idx = tid + i * GEMM_THREADS;
            int r = idx / (A_COLS / VEC), c = (idx % (A_COLS / VEC)) * VEC;
            int gr = TRANS_A ? k0 + r : m0 + r;
            int gc = TRANS_A ? m0 + c : k0 + c;
            ra[i] = load_chunk<T>(A, lda, a_rows, a_cols, gr, gc, a_vec);
        }
#pragma unroll
        for (int i = 0; i < B_CHUNKS; ++i) {
            int idx = tid + i * GEMM_THREADS;
            int r = idx / (GEMM_BN / VEC), c = (idx % (GEMM_BN / VEC)) * VEC;
            rb[i] = load_chunk<T>(B, ldb, K, N, k0 + r, n0 + c, b_vec);
        }
    };
    auto store_tiles = [&]() {
#pragma unroll
        for (int i = 0; i < A_CHUNKS; ++i) {
            int idx = tid + i * GEMM_THREADS;
            int r = idx / (A_COLS / VEC), c = (idx % (A_COLS / VEC)) * VEC;
            *reinterpret_cast<uint4*>(&As[r * A_LD + c]) = ra[i];
        }
#pragma unroll
        for (int i = 0; i < B_CHUNKS; ++i) {
            int idx = tid + i * GEMM_THREADS;
            int r = idx / (GEMM_BN / VEC), c = (idx % (GEMM_BN / VEC)) * VEC;
            *reinterpret_cast<uint4*>(&Bs[r * B_LD + c]) = rb[i];
        }
    };

    using ALayout = typename std::conditional<TRANS_A, wmma::col_major, wmma::row_major>::type;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    const int nk = (K + GEMM_BK - 1) / GEMM_BK;
    load_tiles(0);
    for (int kt = 0; kt < nk; ++kt) {
        store_tiles();
        __syncthreads();
        if (kt + 1 < nk) load_tiles((kt + 1) * GEMM_BK);
#pragma unroll
        for (int kk = 0; kk < GEMM_BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, ALayout> af[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                int mrow = wm * 32 + i * 16;
                const T* p = TRANS_A ? &As[kk * A_LD + mrow] : &As[mrow * A_LD + kk];
                wmma::load_matrix_sync(af[i], p, A_LD);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(bf[j], &Bs[kk * B_LD + wn * 32 + j * 16], B_LD);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * C_LD + wn * 32 + j * 16], acc[i][j], C_LD,
                                    wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < GEMM_BM * GEMM_BN; idx += GEMM_THREADS) {
        int r = idx / GEMM_BN, c = idx % GEMM_BN;
        int gm = m0 + r, gn = n0 + c;
        if (gm < M && gn < N) C[(size_t)gm * ldc + gn] = from_f32<OutT>(Cs[r * C_LD + c]);
    }
}

// ---------------------------------------------------------------------------
// fp32: FMA units, full fp32 products.
// ---------------------------------------------------------------------------
template <bool TRANS_A>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                int M, int N, int K, int lda, int ldb, int ldc, long long sa, long long sb, long long sc,
                bool a_vec, bool b_vec) {
    constexpr int VEC = 4;
    constexpr int A_ROWS = TRANS_A ? GEMM_BK : GEMM_BM;
    constexpr int A_COLS = TRANS_A ? GEMM_BM : GEMM_BK;
    constexpr int AS_LD = GEMM_BM + 4;  // As is always [k][m]
    constexpr int B_LD = GEMM_BN + 4;
    constexpr int A_CHUNKS = A_ROWS * A_COLS / VEC / GEMM_THREADS;  // 4
    constexpr int B_CHUNKS = GEMM_BK * GEMM_BN / VEC / GEMM_THREADS;  // 4
    __shared__ __align__(16) float As[GEMM_BK * AS_LD];
    __shared__ __align__(16) float Bs[GEMM_BK * B_LD];

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.y * GEMM_BM;
    const int n0 = blockIdx.x * GEMM_BN;
    A += blockIdx.z * sa;
    B += blockIdx.z * sb;
    C += blockIdx.z * sc;
    const int a_rows = TRANS_A ? K : M;
    const int a_cols = TRANS_A ? M : K;

    uint4 ra[A_CHUNKS], rb[B_CHUNKS];
    auto load_tiles = [&](int k0) {
#pragma unroll
        for (int i = 0; i < A_CHUNKS; ++i) {
            int idx = tid + i * GEMM_THREADS;
            int r = idx / (A_COLS / VEC), c = (idx % (A_COLS / VEC)) * VEC;
            int gr = TRANS_A ? k0 + r : m0 + r;
            int gc = TRANS_A ? m0 + c : k0 + c;
            ra[i] = load_chunk<float>(A, lda, a_rows, a_cols, gr, gc, a_vec);
        }
#pragma unroll
        for (int i = 0; i < B_CHUNKS; ++i) {
            int idx = tid + i * GEMM_THREADS;
            int r = idx / (GEMM_BN / VEC), c = (idx % (GEMM_BN / VEC)) * VEC;
            rb[i] = load_chunk<float>(B, ldb, K, N, k0 + r, n0 + c, b_vec);
        }
    };
    auto store_tiles = [&]() {
#pragma unroll
        for (int i = 0; i < A_CHUNKS; ++i) {
            int idx = tid + i * GEMM_THREADS;
            int r = idx / (A_COLS / VEC), c = (idx % (A_COLS / VEC)) * VEC;
            const float* v = reinterpret_cast<const float*>(&ra[i]);
            if (TRANS_A) {
                *reinterpret_cast<uint4*>(&As[r * AS_LD + c]) = ra[i];
            } else {
#pragma unroll
                for (int e = 0; e < VEC; ++e) As[(c + e) * AS_LD + r] = v[e];
            }
        }
#pragma unroll
        for (int i = 0; i < B_CHUNKS; ++i) {
            int idx = tid + i * GEMM_THREADS;
            int r = idx / (GEMM_BN / VEC), c = (idx % (GEMM_BN / VEC)) * VEC;
            *reinterpret_cast<uint4*>(&Bs[r * B_LD + c]) = rb[i];
        }
    };

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    const int nk = (K + GEMM_BK - 1) / GEMM_BK;
    load_tiles(0);
    for (int kt = 0; kt < nk; ++kt) {
        store_tiles();
        __syncthreads();
        if (kt + 1 < nk) load_tiles((kt + 1) * GEMM_BK);
#pragma unroll 4
        for (int kk = 0; kk < GEMM_BK; ++kk) {
            float a[8], b[4];
#pragma unroll
            for (int i = 0; i < 8; ++i) a[i] = As[kk * AS_LD + ty + 8 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[kk * B_LD + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        int gm = m0 + ty + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            int gn = n0 + tx + 16 * j;
            if (gm < M && gn < N) C[(size_t)gm * ldc + gn] = acc[i][j];
        }
    }
}

// ---------------------------------------------------------------------------
// Skinny M (decode: M = batch <= 8): split-K over many blocks.
//
// With M this small the tiles above leave the SMs idle (stage 1 of a
// decode-time low-rank linear gets ~10 blocks, each walking all of K), and
// the work is the bytes of B.  Here each block owns a 32*VEC-column slice of
// B and a KC-row chunk of K; its four warps take every fourth row of the
// chunk, each thread streaming VEC columns of B with one 16-byte load per
// row, four rows in flight at a time.  Partial sums go to an fp32 workspace [split][M][N]; a second pass
// adds the splits in a fixed order (deterministic) and rounds to OutT.
// ---------------------------------------------------------------------------
constexpr int SKINNY_MAX_M = 8;
constexpr int SKINNY_THREADS = 128;
constexpr int SKINNY_WARPS = SKINNY_THREADS / 32;
constexpr int SKINNY_TARGET_BLOCKS = 264;  // two waves of the 132 SMs

struct SkinnyPlan {
    int col_tiles, splits, kc;
};

template <typename T>
inline SkinnyPlan skinny_plan(int N, int K) {
    constexpr int VEC = 16 / sizeof(T);
    SkinnyPlan p;
    p.col_tiles = (N + 32 * VEC - 1) / (32 * VEC);
    int want = (SKINNY_TARGET_BLOCKS + p.col_tiles - 1) / p.col_tiles;
    int max_splits = (K + 15) / 16;      // at least 16 rows (4 per warp) per split
    int min_splits = (K + 2047) / 2048;  // at most 2048 rows, so A's chunk fits in shared memory
    p.splits = want > max_splits ? max_splits : want;
    if (p.splits < min_splits) p.splits = min_splits;
    if (p.splits < 1) p.splits = 1;
    p.kc = (K + p.splits - 1) / p.splits;
    p.splits = (K + p.kc - 1) / p.kc;
    return p;
}

template <typename T>
inline size_t skinny_workspace_bytes(int M, int N, int K) {
    SkinnyPlan p = skinny_plan<T>(N, K);
    return sizeof(float) * (size_t)p.splits * M * N;
}

template <typename T>
__global__ void __launch_bounds__(SKINNY_THREADS)
gemm_skinny_partial_kernel(const T* __restrict__ A, const T* __restrict__ B, float* __restrict__ ws, int M, int N,
                           int K, int lda, int ldb, int kc, bool b_vec) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int COLS = 32 * VEC;
    extern __shared__ float sm[];
    float* As = sm;                                // [M][kc]
    float* red = As + SKINNY_MAX_M * kc;           // [WARPS][M][COLS]
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int n0 = blockIdx.x * COLS + lane * VEC;
    const int split = blockIdx.y;
    const int k0 = split * kc;
    const int k1 = min(K, k0 + kc);

    for (int i = tid; i < M * kc; i += SKINNY_THREADS) {
        int m = i / kc, k = k0 + i % kc;
        As[i] = k < k1 ? to_f32<T>(A[(size_t)m * lda + k]) : 0.f;
    }
    __syncthreads();

    float acc[SKINNY_MAX_M][VEC];
#pragma unroll
    for (int m = 0; m < SKINNY_MAX_M; ++m)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[m][j] = 0.f;

    auto accumulate = [&](const uint4& raw, int kk) {
        const T* bv = reinterpret_cast<const T*>(&raw);
        float b[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) b[j] = to_f32<T>(bv[j]);
#pragma unroll
        for (int m = 0; m < SKINNY_MAX_M; ++m) {
            if (m < M) {
                float a = As[m * kc + kk];
#pragma unroll
                for (int j = 0; j < VEC; ++j) acc[m][j] = fmaf(a, b[j], acc[m][j]);
            }
        }
    };
    // four rows of B in flight per warp, then their products
    constexpr int DEPTH = 4;
    int k = k0 + warp;
    for (; k + (DEPTH - 1) * SKINNY_WARPS < k1; k += DEPTH * SKINNY_WARPS) {
        uint4 raw[DEPTH];
#pragma unroll
        for (int u = 0; u < DEPTH; ++u) raw[u] = load_chunk<T>(B, ldb, K, N, k + u * SKINNY_WARPS, n0, b_vec);
#pragma unroll
        for (int u = 0; u < DEPTH; ++u) accumulate(raw[u], k + u * SKINNY_WARPS - k0);
    }
    for (; k < k1; k += SKINNY_WARPS) accumulate(load_chunk<T>(B, ldb, K, N, k, n0, b_vec), k - k0);
#pragma unroll
    for (int m = 0; m < SKINNY_MAX_M; ++m)
        if (m < M)
#pragma unroll
            for (int j = 0; j < VEC; ++j) red[(warp * SKINNY_MAX_M + m) * COLS + lane * VEC + j] = acc[m][j];
    __syncthreads();
    for (int i = tid; i < M * COLS; i += SKINNY_THREADS) {
        int m = i / COLS, c = i % COLS, n = blockIdx.x * COLS + c;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < SKINNY_WARPS; ++w) sum += red[(w * SKINNY_MAX_M + m) * COLS + c];
        if (n < N) ws[((size_t)split * M + m) * N + n] = sum;
    }
}

template <typename OutT>
__global__ void gemm_skinny_reduce_kernel(const float* __restrict__ ws, OutT* __restrict__ C, int M, int N,
                                          int ldc, int splits) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= M * N) return;
    int m = i / N, n = i % N;
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += ws[((size_t)s * M + m) * N + n];
    C[(size_t)m * ldc + n] = from_f32<OutT>(sum);
}

template <typename T, typename OutT>
inline cudaError_t launch_gemm_skinny(const void* A, const void* B, void* C, void* ws, int M, int N, int K, int lda,
                                      int ldb, int ldc, cudaStream_t stream) {
    if (M <= 0 || N <= 0) return cudaSuccess;
    if (M > SKINNY_MAX_M) return cudaErrorInvalidValue;
    SkinnyPlan p = skinny_plan<T>(N, K);
    constexpr int COLS = 32 * (16 / sizeof(T));
    size_t smem = sizeof(float) * ((size_t)SKINNY_MAX_M * p.kc + (size_t)SKINNY_WARPS * SKINNY_MAX_M * COLS);
    cudaError_t e = allow_smem(gemm_skinny_partial_kernel<T>, smem);
    if (e != cudaSuccess) return e;
    bool bv = (reinterpret_cast<uintptr_t>(B) % 16 == 0) && ((size_t)ldb * sizeof(T)) % 16 == 0;
    dim3 grid(p.col_tiles, p.splits);
    gemm_skinny_partial_kernel<T><<<grid, SKINNY_THREADS, smem, stream>>>(
        static_cast<const T*>(A), static_cast<const T*>(B), static_cast<float*>(ws), M, N, K, lda, ldb, p.kc, bv);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    int total = M * N;
    gemm_skinny_reduce_kernel<OutT><<<(total + 255) / 256, 256, 0, stream>>>(static_cast<const float*>(ws),
                                                                          static_cast<OutT*>(C), M, N, ldc, p.splits);
    return cudaGetLastError();
}

// 16-byte vector loads need the base, the row stride and (for a stack) the
// stack stride all on 16-byte boundaries.
inline bool vec_ok(const void* p, int ld, int elem_bytes, long long stack_stride = 0) {
    return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && ((size_t)ld * elem_bytes) % 16 == 0 &&
           ((size_t)stack_stride * elem_bytes) % 16 == 0;
}

// C[z] = op(A[z]) @ B[z] for z < batch (the strides are ignored when batch == 1).
template <typename OutT>
inline cudaError_t launch_gemm_bf16(const void* A, const void* B, void* C, int M, int N, int K, int lda, int ldb,
                                    int ldc, bool trans_a, cudaStream_t stream, int batch = 1, long long sa = 0,
                                    long long sb = 0, long long sc = 0) {
    if (M <= 0 || N <= 0 || batch <= 0) return cudaSuccess;
    if (batch > 65535) return cudaErrorInvalidValue;
    dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM, batch);
    bool av = vec_ok(A, lda, 2, sa), bv = vec_ok(B, ldb, 2, sb);
    auto* a = static_cast<const __nv_bfloat16*>(A);
    auto* b = static_cast<const __nv_bfloat16*>(B);
    auto* c = static_cast<OutT*>(C);
    if (trans_a)
        gemm_bf16_kernel<true, OutT><<<grid, GEMM_THREADS, 0, stream>>>(a, b, c, M, N, K, lda, ldb, ldc, sa, sb, sc,
                                                                         av, bv);
    else
        gemm_bf16_kernel<false, OutT><<<grid, GEMM_THREADS, 0, stream>>>(a, b, c, M, N, K, lda, ldb, ldc, sa, sb, sc,
                                                                          av, bv);
    return cudaGetLastError();
}

inline cudaError_t launch_gemm_f32(const void* A, const void* B, void* C, int M, int N, int K, int lda, int ldb,
                                   int ldc, bool trans_a, cudaStream_t stream, int batch = 1, long long sa = 0,
                                   long long sb = 0, long long sc = 0) {
    if (M <= 0 || N <= 0 || batch <= 0) return cudaSuccess;
    if (batch > 65535) return cudaErrorInvalidValue;
    dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + GEMM_BM - 1) / GEMM_BM, batch);
    bool av = vec_ok(A, lda, 4, sa), bv = vec_ok(B, ldb, 4, sb);
    auto* a = static_cast<const float*>(A);
    auto* b = static_cast<const float*>(B);
    auto* c = static_cast<float*>(C);
    if (trans_a)
        gemm_f32_kernel<true><<<grid, GEMM_THREADS, 0, stream>>>(a, b, c, M, N, K, lda, ldb, ldc, sa, sb, sc, av, bv);
    else
        gemm_f32_kernel<false><<<grid, GEMM_THREADS, 0, stream>>>(a, b, c, M, N, K, lda, ldb, ldc, sa, sb, sc, av, bv);
    return cudaGetLastError();
}

}  // namespace repro
